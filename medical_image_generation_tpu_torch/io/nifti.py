"""Minimal, self-contained NIfTI-1 reader/writer: the port's own copy.

Copied from ``medical_image_generation_tpu/io/nifti.py`` (:1-232) so the
port reads and writes NIfTI without importing the JAX package (and without
nibabel): reading (optionally gzipped) images with the common datatypes,
scl_slope/scl_inter scaling, affine resolution (sform > qform > pixdim),
and writing float/int volumes with an sform affine. The sampling CLI writes
its 3D samples with ``save_nifti``.

NIfTI-1 is a fixed 348-byte little/big-endian header followed by raw voxel
data at ``vox_offset``; see the official nifti1.h field layout.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

_HDR_SIZE = 348

# NIfTI datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """A loaded NIfTI volume: raw data array + 4x4 affine."""

    data: np.ndarray
    affine: np.ndarray  # (4, 4) float64

    @property
    def shape(self):
        return self.data.shape

    @property
    def spacing(self) -> np.ndarray:
        """Voxel spacing as column norms of the affine rotation block.

        Mirrors the reference's ``extract_spacing`` (configuration.py:1036-1039).
        """
        return np.sqrt(np.sum(self.affine[:3, :3] ** 2, axis=0))

    def get_fdata(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.float64)


def _quaternion_to_affine(b, c, d, qx, qy, qz, dx, dy, dz, qfac):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    r = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = -1.0 if qfac < 0 else 1.0
    aff = np.eye(4)
    aff[:3, :3] = r * np.array([dx, dy, dz * qfac])
    aff[:3, 3] = [qx, qy, qz]
    return aff


def _open_maybe_gzip(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def load_nifti(path: str) -> NiftiImage:
    """Load a .nii / .nii.gz file.

    Applies scl_slope/scl_inter when meaningful (slope not in {0, 1} or
    inter != 0), returning float32 in that case.
    """
    with _open_maybe_gzip(path) as f:
        raw = f.read()

    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        endian = ">"

    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: invalid ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    # NIfTI allows trailing singleton dims; drop dims of size <= 1 beyond ndim
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]

    datatype = struct.unpack_from(endian + "h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    vox_offset = int(struct.unpack_from(endian + "f", raw, 108)[0])
    scl_slope = struct.unpack_from(endian + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", raw, 116)[0]
    qform_code = struct.unpack_from(endian + "h", raw, 252)[0]
    sform_code = struct.unpack_from(endian + "h", raw, 254)[0]

    n_items = int(np.prod(shape))
    start = vox_offset if vox_offset >= _HDR_SIZE else _HDR_SIZE
    data = np.frombuffer(raw, dtype=dtype, count=n_items, offset=start)
    # NIfTI data is Fortran-ordered (x fastest)
    data = data.reshape(shape, order="F")

    if sform_code > 0:
        srow = struct.unpack_from(endian + "12f", raw, 280)
        affine = np.eye(4)
        affine[0, :] = srow[0:4]
        affine[1, :] = srow[4:8]
        affine[2, :] = srow[8:12]
    elif qform_code > 0:
        b, c, d = struct.unpack_from(endian + "3f", raw, 256)
        qx, qy, qz = struct.unpack_from(endian + "3f", raw, 268)
        affine = _quaternion_to_affine(
            b, c, d, qx, qy, qz, pixdim[1], pixdim[2], pixdim[3], pixdim[0]
        )
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])

    # NIfTI-1: scl_slope == 0 (or non-finite) means "no scaling" — both
    # fields are ignored then, even if scl_inter holds a stale value.
    if (
        np.isfinite(scl_slope)
        and scl_slope != 0.0
        and np.isfinite(scl_inter)
        and (scl_slope != 1.0 or scl_inter != 0.0)
    ):
        data = data.astype(np.float32) * np.float32(scl_slope) + np.float32(scl_inter)
    else:
        data = data.astype(dtype.newbyteorder("="))

    return NiftiImage(data=data, affine=affine)


def save_nifti(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None) -> None:
    """Write a .nii / .nii.gz file with an sform affine."""
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    affine = np.asarray(affine, dtype=np.float64)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    dt_code = _DTYPE_CODES[np.dtype(data.dtype)]

    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    spacing = np.sqrt(np.sum(affine[:3, :3] ** 2, axis=0))
    pixdim = [1.0] + list(spacing[: min(3, ndim)]) + [1.0] * (7 - min(3, ndim))

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, dt_code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = NIFTI_XFORM_SCANNER_ANAT
    struct.pack_into("<12f", hdr, 280, *affine[0, :], *affine[1, :], *affine[2, :])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + np.asfortranarray(data).tobytes(order="F")
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=4) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def extract_spacing(path: str) -> np.ndarray:
    """Voxel spacing of a NIfTI file (reference: configuration.py:1036-1039).

    Header-only fast path: decompresses just the first 348 bytes.
    """
    with _open_maybe_gzip(path) as f:
        raw = f.read(_HDR_SIZE)
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    endian = "<" if struct.unpack_from("<i", raw, 0)[0] == _HDR_SIZE else ">"
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    qform_code = struct.unpack_from(endian + "h", raw, 252)[0]
    sform_code = struct.unpack_from(endian + "h", raw, 254)[0]
    if sform_code > 0:
        srow = struct.unpack_from(endian + "12f", raw, 280)
        affine3 = np.array([srow[0:3], srow[4:7], srow[8:11]])
        return np.sqrt(np.sum(affine3**2, axis=0))
    if qform_code > 0:
        b, c, d = struct.unpack_from(endian + "3f", raw, 256)
        qx, qy, qz = struct.unpack_from(endian + "3f", raw, 268)
        aff = _quaternion_to_affine(
            b, c, d, qx, qy, qz, pixdim[1], pixdim[2], pixdim[3], pixdim[0]
        )
        return np.sqrt(np.sum(aff[:3, :3] ** 2, axis=0))
    return np.array([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0])
