"""Dataset fingerprinting: median spacing / shape, intensity extrema, quality.

The port's own copy of ``medical_image_generation_tpu/planning/
fingerprint.py`` (:1-177; reference configuration.py:1036-1320):
``otsu_threshold``, ``calculate_median_spacing``, ``_fingerprint_one``,
``calculate_dataset_fingerprint`` and the per-slice Laplacian-variance
screen that flags low-quality volumes (otsu / 5th-percentile / integer
thresholds). Per-volume work fans out over a pool of spawned processes.

The Laplacian is computed in NumPy with OpenCV's 3x3 kernel and its
default border (BORDER_REFLECT_101), and the module never imports ``cv2``:
it gives the numbers the JAX package gives where OpenCV is installed, on
any machine. (Without OpenCV the JAX module takes a stencil over the
interior only, which moves a slice's variance by several percent.)
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from medical_image_generation_tpu_torch.io.nifti import extract_spacing, load_nifti
from medical_image_generation_tpu_torch.planning.preprocess import (
    crop_to_nonzero,
    normalize_zscore_then_minmax,
    resample_image,
    to_canonical_axes,
)


def process_pool(max_workers: Optional[int]) -> ProcessPoolExecutor:
    """A process pool whose workers are spawned, not forked: the caller may
    hold a CUDA context and a data loader's threads, which a fork would
    copy into a child that cannot use them. A spawned worker imports the
    caller's main module, so that must be a file guarded by ``if __name__
    == "__main__"`` (or ``python -c`` / ``-m``), not a script read from
    standard input."""
    return ProcessPoolExecutor(max_workers=max_workers,
                               mp_context=multiprocessing.get_context("spawn"))


def laplacian(image: np.ndarray) -> np.ndarray:
    """float64 Laplacian of a 2D array with the 3x3 kernel [[0, 1, 0], [1,
    -4, 1], [0, 1, 0]] and BORDER_REFLECT_101 (the border's first row or
    column mirrored about the edge, the edge itself not repeated):
    ``cv2.Laplacian(image, cv2.CV_64F)`` in NumPy."""
    f = image.astype(np.float64)
    p = np.pad(f, 1, mode="reflect")
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4.0 * f


def compute_laplacian_variance(slice_2d: np.ndarray) -> float:
    """Laplacian variance of a min-max-normalized uint8 slice — sharpness
    proxy (reference configuration.py:1247-1251), on every pixel with the
    border OpenCV's ``Laplacian`` uses (``laplacian``)."""
    smin, smax = float(np.min(slice_2d)), float(np.max(slice_2d))
    denom = (smax - smin) if smax > smin else 1.0
    norm = ((slice_2d - smin) / denom * 255.0).astype(np.uint8)
    return float(laplacian(norm).var())


def otsu_threshold(values: np.ndarray, nbins: int = 256) -> float:
    """Otsu's method over a 1-D sample (replaces skimage.threshold_otsu)."""
    values = np.asarray(values, dtype=np.float64)
    hist, bin_edges = np.histogram(values, bins=nbins)
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    hist = hist.astype(np.float64)
    total = hist.sum()
    w0 = np.cumsum(hist)  # weight of class 0 when splitting after bin t
    w1 = total - w0
    sum0 = np.cumsum(hist * centers)
    m0 = sum0 / np.maximum(w0, 1e-12)
    m1 = (sum0[-1] - sum0) / np.maximum(w1, 1e-12)
    between = w0 * w1 * (m0 - m1) ** 2
    between[-1] = 0.0  # splitting after the last bin is degenerate
    return float(centers[np.argmax(between)])


def calculate_median_spacing(image_paths: Sequence[str]):
    """Median voxel spacing across the dataset (configuration.py:1042-1045).
    The headers are read in this process: the JAX package's process pool
    costs seconds of spawned workers here for milliseconds of work."""
    if len(image_paths) == 0:
        raise ValueError("no images found")
    spacings = [extract_spacing(p) for p in image_paths]
    return tuple(float(v) for v in np.median(np.asarray(spacings), axis=0))


def _fingerprint_one(
    path: str, median_spacing: Sequence[float], input_channels: Optional[Sequence[int]]
) -> Tuple[Tuple[int, ...], List[Tuple[float, float]], Dict]:
    """Shape + per-channel min/max + per-channel quality for one volume
    (reference configuration.py:1254-1276)."""
    nii = load_nifti(path)
    data = nii.get_fdata()
    if data.ndim == 4:
        resampled = np.stack(
            [resample_image(data[..., c], nii.spacing, median_spacing) for c in range(data.shape[-1])],
            axis=-1,
        )
    else:
        resampled = resample_image(data, nii.spacing, median_spacing)
    crop_src = resampled if resampled.ndim == 3 else resampled[..., 0]
    _, _, (mins, maxs) = crop_to_nonzero(crop_src)
    sl = tuple(slice(int(a), int(b) + 1) for a, b in zip(mins, maxs))
    cropped = resampled[sl] if resampled.ndim == 3 else resampled[sl + (slice(None),)]
    cropped = to_canonical_axes(cropped)

    channels = (
        list(input_channels) if input_channels is not None else list(range(cropped.shape[0]))
    )
    quality: Dict = {"pass": True}
    for c in range(cropped.shape[0]):
        if c in channels:
            lap_vars = [
                compute_laplacian_variance(cropped[c, z]) for z in range(cropped.shape[1])
            ]
            quality[f"Channel {c}"] = float(np.mean(lap_vars))

    _, min_max = normalize_zscore_then_minmax(cropped)
    return tuple(int(s) for s in cropped.shape), min_max, quality


def calculate_dataset_fingerprint(
    image_paths: Sequence[str],
    median_spacing: Sequence[float],
    input_channels: Optional[Sequence[int]],
    lq_threshold,
    max_workers: Optional[int] = None,
):
    """Aggregate shapes / intensity extrema / quality flags
    (reference configuration.py:1279-1320)."""
    fn = partial(
        _fingerprint_one, median_spacing=median_spacing, input_channels=input_channels
    )
    if max_workers == 0 or len(image_paths) <= 2:
        results = [fn(p) for p in image_paths]
    else:
        with process_pool(max_workers) as ex:
            results = list(ex.map(fn, image_paths))

    shapes, min_max_per_channel, quality_dicts = zip(*results)
    shapes_arr = np.asarray(shapes)
    median_shape = tuple(int(v) for v in np.median(shapes_arr, axis=0).astype(int))
    min_shape = tuple(int(v) for v in np.min(shapes_arr, axis=0))
    max_shape = tuple(int(v) for v in np.max(shapes_arr, axis=0))

    mm = np.asarray(min_max_per_channel)  # (n_images, n_channels, 2)
    global_channel_min = mm[..., 0].min(axis=0).tolist()
    global_channel_max = mm[..., 1].max(axis=0).tolist()

    channels = (
        list(input_channels) if input_channels is not None else list(range(median_shape[0]))
    )
    quality_dicts = [dict(q) for q in quality_dicts]
    for c in channels:
        if lq_threshold is None:
            continue
        lap_vars = np.array([q[f"Channel {c}"] for q in quality_dicts])
        if lq_threshold == "otsu":
            threshold = otsu_threshold(lap_vars)
        elif lq_threshold == "percentile":
            threshold = float(np.percentile(lap_vars, 5))
        elif isinstance(lq_threshold, int):
            threshold = float(lq_threshold)
        else:
            raise ValueError(
                "lq_threshold must be None, 'otsu', 'percentile' or an integer"
            )
        for q in quality_dicts:
            if q[f"Channel {c}"] < threshold:
                q["pass"] = False

    return (
        median_shape,
        min_shape,
        max_shape,
        global_channel_min,
        global_channel_max,
        quality_dicts,
    )
