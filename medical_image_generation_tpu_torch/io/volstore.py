"""VolStore: single-file chunked, compressed N-d volume store with lazy bbox reads.

The port's own copy of ``medical_image_generation_tpu/io/volstore.py``
(:1-391). The file format is the same, byte for byte, so each package reads
the other's files:

    magic           8 bytes   b"MIGVS01\\0"
    meta_len        u64       length of the JSON metadata blob
    meta            bytes     JSON: dtype, shape, chunk_shape, codec,
                              shuffle, offsets[], csizes[]
    payload         bytes     concatenated compressed chunks (row-major
                              chunk-grid order)

Chunks are stored zero-padded to the full chunk shape (uniform decode size).

The hot codec path (zstd + byte shuffle, chunk gather/scatter, bbox assembly
with zero padding) is the C++ library ``native/volcodec.cpp``, bound with
ctypes. It is built with ``g++`` on first use into ``build/torch_host/``
beside the package (git-ignored), as ``ops/_build.py`` does for the CUDA
kernels, against the runtime library ``libzstd.so.1`` with the codec's own
declarations of the four zstd functions it calls (no ``zstd.h`` needed). The
library's name is a hash of the source, the flags and the target that
``-march=native`` resolves to on this host (``host_target``), so a library
built on another machine is never loaded. When the build fails (no
compiler, no ``libzstd``), files are written with the reference's
pure-Python zlib codec (:209-225, :323-358) and a zstd file cannot be read
(:315-319). The first use prints which codec is in use, and the build
error if there was one.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import json
import os
import struct
import subprocess
import sys
import threading
import zlib
from typing import Optional, Sequence

import numpy as np

_MAGIC = b"MIGVS01\x00"

# ---------------------------------------------------------------------------
# native library: lazy build, load
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(_PKG_DIR, "io", "native", "volcodec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_host")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_lib_name = ""  # the file of the loaded library
build_error: Optional[str] = None  # why a native build failed, if one did


def host_target() -> str:
    """What ``-march=native`` resolves to here: ``g++ -march=native -Q
    --help=target`` (the CPU and every target option it enables), or the
    error if that cannot run."""
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS[:2], "-Q", "--help=target"],
                              capture_output=True, text=True, timeout=60)
        return proc.stdout if proc.returncode == 0 else f"g++ exited {proc.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++: {e}"


def link_flags() -> tuple:
    """The libraries the codec links: zstd's runtime library by its file
    name (``-l:libzstd.so.1``), so no development package is needed."""
    runtime = ctypes.util.find_library("zstd")
    return (f"-l:{runtime}" if runtime else "-lzstd", "-lpthread")


def lib_path() -> str:
    """Library path named by a hash of the source, the flags and the host's
    resolved target."""
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *link_flags())).encode())
    h.update(host_target().encode())
    with open(_SRC_PATH, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvolcodec-{h.hexdigest()[:16]}.so")


def _build_native(out: str) -> Optional[str]:
    """Compile the codec into ``out``; returns the error text, or None."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, _SRC_PATH, "-o", tmp, *link_flags()]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        return f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr.strip()}"
    os.replace(tmp, out)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.vsc_compress.restype = ctypes.c_void_p
    lib.vsc_compress.argtypes = [
        ctypes.c_void_p,  # array
        ctypes.c_int,  # ndim
        i64p,  # shape
        i64p,  # chunk_shape
        ctypes.c_int64,  # itemsize
        ctypes.c_int,  # level
        ctypes.c_int,  # shuffle
        ctypes.c_int,  # nthreads
    ]
    lib.vsc_num_chunks.restype = ctypes.c_int64
    lib.vsc_num_chunks.argtypes = [ctypes.c_void_p]
    lib.vsc_chunk_size.restype = ctypes.c_int64
    lib.vsc_chunk_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.vsc_copy_chunk.restype = None
    lib.vsc_copy_chunk.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.vsc_free.restype = None
    lib.vsc_free.argtypes = [ctypes.c_void_p]
    lib.vsc_read_bbox.restype = ctypes.c_int
    lib.vsc_read_bbox.argtypes = [
        ctypes.c_char_p,  # path
        ctypes.c_int64,  # data_offset
        i64p,  # offsets
        i64p,  # csizes
        ctypes.c_int,  # ndim
        i64p,  # shape
        i64p,  # chunk_shape
        ctypes.c_int64,  # itemsize
        ctypes.c_int,  # shuffle
        i64p,  # lbs
        i64p,  # ubs
        ctypes.c_void_p,  # out
        ctypes.c_int,  # nthreads
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed, build_error, _lib_name
    if _lib is not None or _lib_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = lib_path()
        err = None if os.path.exists(path) else _build_native(path)
        if err is None:
            try:
                _lib, _lib_name = _bind(ctypes.CDLL(path)), os.path.basename(path)
            except OSError as e:
                err = f"loading {path}: {e}"
        if _lib is None:
            _lib_failed = True
        build_error = err
        if build_error:
            sys.stderr.write(f"[volstore] native codec build failed:\n{build_error}\n")
        print(f"[volstore] codec: {_describe()}")
        return _lib


def _describe() -> str:
    return f"zstd (native, {_lib_name})" if _lib is not None else "zlib (python fallback)"


def codec_in_use() -> str:
    """'zstd (native, <library>)' or 'zlib (python fallback)', building the
    native codec first if it was not tried yet."""
    _get_lib()
    return _describe()


def _i64_array(vals: Sequence[int]):
    return (ctypes.c_int64 * len(vals))(*[int(v) for v in vals])


def _default_threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


# ---------------------------------------------------------------------------
# pure-python fallback codec (zlib + byte shuffle via numpy)
# ---------------------------------------------------------------------------


def _py_shuffle(buf: np.ndarray, itemsize: int) -> bytes:
    if itemsize <= 1:
        return buf.tobytes()
    b = buf.reshape(-1).view(np.uint8).reshape(-1, itemsize)
    return np.ascontiguousarray(b.T).tobytes()


def _py_unshuffle(raw: bytes, itemsize: int, dtype, shape) -> np.ndarray:
    if itemsize <= 1:
        return np.frombuffer(raw, dtype=dtype).reshape(shape)
    b = np.frombuffer(raw, dtype=np.uint8).reshape(itemsize, -1)
    flat = np.ascontiguousarray(b.T).reshape(-1).view(dtype)
    return flat.reshape(shape)


def _chunk_origins(shape, chunk_shape):
    grids = [range(0, s, c) for s, c in zip(shape, chunk_shape)]
    out = [[]]
    for g in grids:
        out = [o + [v] for o in out for v in g]
    return [tuple(o) for o in out]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def write_volume(
    path: str,
    array: np.ndarray,
    chunk_shape: Optional[Sequence[int]] = None,
    level: int = 5,
    shuffle: bool = True,
) -> None:
    """Write an N-d array as a chunked-compressed .vs file.

    Default chunking matches the reference's access pattern: (C, Z, Y, X)
    volumes chunked as (1, 1, Y, X) slices (configuration.py:1408-1409) so the
    patch sampler can read z-slabs without decompressing the whole volume.
    """
    array = np.ascontiguousarray(array)
    if chunk_shape is None:
        chunk_shape = [1] * (array.ndim - 2) + list(array.shape[-2:])
    chunk_shape = [int(min(c, s)) for c, s in zip(chunk_shape, array.shape)]

    lib = _get_lib()
    codec = "zstd+shuffle" if shuffle else "zstd"
    blobs = []
    if lib is not None:
        handle = lib.vsc_compress(
            array.ctypes.data_as(ctypes.c_void_p),
            array.ndim,
            _i64_array(array.shape),
            _i64_array(chunk_shape),
            array.itemsize,
            int(level),
            1 if shuffle else 0,
            _default_threads(),
        )
        if not handle:
            raise RuntimeError("vsc_compress failed")
        try:
            n = lib.vsc_num_chunks(handle)
            for i in range(n):
                sz = lib.vsc_chunk_size(handle, i)
                buf = ctypes.create_string_buffer(sz)
                lib.vsc_copy_chunk(handle, i, buf)
                blobs.append(buf.raw)
        finally:
            lib.vsc_free(handle)
    else:
        codec = "zlib+shuffle" if shuffle else "zlib"
        full = np.zeros(chunk_shape, dtype=array.dtype)
        for origin in _chunk_origins(array.shape, chunk_shape):
            sl = tuple(
                slice(o, min(o + c, s)) for o, c, s in zip(origin, chunk_shape, array.shape)
            )
            piece = array[sl]
            if piece.shape != tuple(chunk_shape):
                full[...] = 0
                full[tuple(slice(0, p) for p in piece.shape)] = piece
                piece = full
            raw = _py_shuffle(piece, array.itemsize) if shuffle else piece.tobytes()
            blobs.append(zlib.compress(raw, min(level, 9)))

    offsets, csizes = [], []
    pos = 0
    for b in blobs:
        offsets.append(pos)
        csizes.append(len(b))
        pos += len(b)

    meta = {
        "dtype": np.dtype(array.dtype).str,
        "shape": [int(s) for s in array.shape],
        "chunk_shape": [int(c) for c in chunk_shape],
        "codec": codec,
        "shuffle": bool(shuffle),
        "offsets": offsets,
        "csizes": csizes,
    }
    meta_b = json.dumps(meta).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(meta_b)))
        f.write(meta_b)
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)


class VolStore:
    """Read handle for a .vs file with lazy, zero-padded bbox reads.

    ``read_bbox(lbs, ubs)`` reproduces the reference's crop_and_pad_nd
    semantics (data_processing.py:148-225): bounds may extend outside the
    array; out-of-bounds voxels come back zero.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != _MAGIC:
                raise ValueError(f"{path}: bad VolStore magic")
            (meta_len,) = struct.unpack("<Q", f.read(8))
            meta = json.loads(f.read(meta_len))
            self._data_offset = 16 + meta_len
        self.dtype = np.dtype(meta["dtype"])
        self.shape = tuple(meta["shape"])
        self.chunk_shape = tuple(meta["chunk_shape"])
        self.codec = meta["codec"]
        self.shuffle = meta["shuffle"]
        self._offsets = meta["offsets"]
        self._csizes = meta["csizes"]
        self._offsets_c = _i64_array(self._offsets)
        self._csizes_c = _i64_array(self._csizes)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def read_bbox(self, lbs: Sequence[int], ubs: Sequence[int]) -> np.ndarray:
        lbs = [int(v) for v in lbs]
        ubs = [int(v) for v in ubs]
        assert len(lbs) == self.ndim and len(ubs) == self.ndim
        out_shape = tuple(u - l for l, u in zip(lbs, ubs))
        out = np.zeros(out_shape, dtype=self.dtype)

        lib = _get_lib() if self.codec.startswith("zstd") else None
        if lib is not None:
            rc = lib.vsc_read_bbox(
                self.path.encode(),
                self._data_offset,
                self._offsets_c,
                self._csizes_c,
                self.ndim,
                _i64_array(self.shape),
                _i64_array(self.chunk_shape),
                self.dtype.itemsize,
                1 if self.shuffle else 0,
                _i64_array(lbs),
                _i64_array(ubs),
                out.ctypes.data_as(ctypes.c_void_p),
                _default_threads(),
            )
            if rc != 0:
                raise RuntimeError(f"vsc_read_bbox failed rc={rc} for {self.path}")
            return out

        if self.codec.startswith("zstd"):
            raise RuntimeError(
                f"{self.path} uses zstd but the native codec is unavailable"
            )
        # pure-python zlib path
        return self._read_bbox_py(lbs, ubs, out)

    def _read_bbox_py(self, lbs, ubs, out):
        grid = [
            -(-s // c) for s, c in zip(self.shape, self.chunk_shape)
        ]  # chunks per dim
        clo = [max(l, 0) for l in lbs]
        chi = [min(u, s) for u, s in zip(ubs, self.shape)]
        if any(lo >= hi for lo, hi in zip(clo, chi)):
            return out
        glo = [lo // c for lo, c in zip(clo, self.chunk_shape)]
        ghi = [(hi - 1) // c + 1 for hi, c in zip(chi, self.chunk_shape)]

        with open(self.path, "rb") as f:
            coords = [[]]
            for lo, hi in zip(glo, ghi):
                coords = [c + [v] for c in coords for v in range(lo, hi)]
            for gc in coords:
                ci = 0
                for d in range(self.ndim):
                    ci = ci * grid[d] + gc[d]
                f.seek(self._data_offset + self._offsets[ci])
                blob = f.read(self._csizes[ci])
                raw = zlib.decompress(blob)
                chunk = _py_unshuffle(raw, self.dtype.itemsize, self.dtype, self.chunk_shape) \
                    if self.shuffle else np.frombuffer(raw, dtype=self.dtype).reshape(self.chunk_shape)
                origin = [g * c for g, c in zip(gc, self.chunk_shape)]
                ilo = [max(o, l) for o, l in zip(origin, clo)]
                ihi = [
                    min(o + c, h, s)
                    for o, c, h, s in zip(origin, self.chunk_shape, chi, self.shape)
                ]
                if any(a >= b for a, b in zip(ilo, ihi)):
                    continue
                src = tuple(slice(a - o, b - o) for a, b, o in zip(ilo, ihi, origin))
                dst = tuple(slice(a - l, b - l) for a, b, l in zip(ilo, ihi, lbs))
                out[dst] = chunk[src]
        return out

    def __getitem__(self, idx) -> np.ndarray:
        """Basic slicing support (integer / slice per dim), loads via read_bbox."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        idx = idx + (slice(None),) * (self.ndim - len(idx))
        lbs, ubs, squeeze = [], [], []
        for d, ix in enumerate(idx):
            if isinstance(ix, int):
                if ix < 0:
                    ix += self.shape[d]
                lbs.append(ix)
                ubs.append(ix + 1)
                squeeze.append(d)
            elif isinstance(ix, slice):
                start, stop, step = ix.indices(self.shape[d])
                if step != 1:
                    raise NotImplementedError("VolStore slicing requires step=1")
                lbs.append(start)
                ubs.append(stop)
            else:
                raise TypeError(f"unsupported index {ix!r}")
        block = self.read_bbox(lbs, ubs)
        if squeeze:
            block = np.squeeze(block, axis=tuple(squeeze))
        return block

    def read_full(self) -> np.ndarray:
        return self.read_bbox([0] * self.ndim, list(self.shape))


def open_volume(path: str) -> VolStore:
    return VolStore(path)
