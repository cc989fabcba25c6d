"""8-bit grayscale PNG files of 2D samples, with zlib and struct only.

The JAX package draws its 2D samples with matplotlib (``training/
plots.py`` ``save_image_grid_2d``, one figure a sample and a grid). The port
writes the same files (``ldm_sample_000.png`` ..., ``*_grid.png``,
``epoch_N.png``) without matplotlib or PIL, which a GPU host need not have:
each PNG holds the sample itself at its own resolution, min-max scaled to
8 bits, and a grid tiles the samples four to a row with a 2-pixel black
gap. ``read_png`` reads such files back.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(img: np.ndarray) -> np.ndarray:
    """(H, W) or (H, W, C) image -> (H, W) uint8, the first channel min-max
    scaled to [0, 255] (a constant image gives 0)."""
    img = np.squeeze(np.asarray(img, dtype=np.float32))
    if img.ndim == 3:
        img = img[..., 0]
    if img.ndim != 2:
        raise ValueError(f"expected a 2D image, got shape {img.shape}")
    mn, mx = float(img.min()), float(img.max())
    denom = (mx - mn) if mx > mn else 1.0
    return ((img - mn) / denom * 255.0).astype(np.uint8)


def image_grid(images: Sequence[np.ndarray], ncols: int = 4, gap: int = 2) -> np.ndarray:
    """uint8 grid of the samples (each scaled on its own), ``ncols`` a row."""
    tiles = [to_uint8(im) for im in images]
    h, w = tiles[0].shape
    ncols = min(ncols, len(tiles))
    nrows = -(-len(tiles) // ncols)
    grid = np.zeros((nrows * h + (nrows - 1) * gap, ncols * w + (ncols - 1) * gap), np.uint8)
    for i, t in enumerate(tiles):
        r, c = divmod(i, ncols)
        grid[r * (h + gap):r * (h + gap) + h, c * (w + gap):c * (w + gap) + w] = t
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a (H, W) uint8 array as an 8-bit grayscale PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected a (H, W) uint8 array, got shape {img.shape}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)  # filter 0 a row
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG that ``write_png`` wrote (8-bit grayscale, no interlace,
    filter 0 on every row) as a (H, W) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = len(_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None or hdr[2:5] != (8, 0, 0) or hdr[6] != 0:
        raise ValueError(f"{path}: not an 8-bit grayscale non-interlaced PNG ({hdr})")
    w, h = hdr[0], hdr[1]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w + 1)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows with a PNG filter other than 0")
    return raw[:, 1:].copy()
