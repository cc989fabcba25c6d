"""Host-side preprocessing: crop -> resample -> normalise -> VolStore write.

The port's own copy of ``medical_image_generation_tpu/planning/
preprocess.py`` (:26-317), NumPy / SciPy on the host: nonzero-bbox crop,
anisotropy-aware axis-wise resampling (cubic image, nearest on the
low-resolution axis; labels by one-hot + linear + argmax), the three
normalisations (z-score -> min-max is the one the pipeline uses, with the
original per-channel min / max recorded), the transpose to (C, Z, Y, X),
the per-patient properties pickle (``class_locations``: at most 50
foreground voxels per class per z-slice, which the patch sampler's
foreground oversampling reads; ``min_max``) and ``process_patient``, which
writes through the port's ``io/volstore.write_volume``.

``process_patient`` chunks volumes as (1, 1, median_Y, median_X), so a
patient wider than the median gets chunks that split the last axis; the
port's writer stores those exactly (the JAX package's native writer does
not: ``tests/test_torch_planning.py``).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from medical_image_generation_tpu_torch.io.nifti import load_nifti
from medical_image_generation_tpu_torch.io.volstore import write_volume

ANISOTROPY_THRESHOLD = 3.0


def is_anisotropic(spacing: Sequence[float], threshold: float = ANISOTROPY_THRESHOLD) -> bool:
    """Max/min spacing ratio above threshold (reference configuration.py:1101-1102)."""
    spacing = np.asarray(spacing, dtype=np.float64)
    return bool((np.max(spacing) / np.min(spacing)) > threshold)


def crop_to_nonzero(
    image: np.ndarray, label: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Crop to the bounding box of nonzero voxels (configuration.py:1048-1071)."""
    nz = np.nonzero(image != 0)
    if len(nz[0]) == 0:
        bbox = (np.zeros(image.ndim, int), np.array(image.shape) - 1)
        return image, label, bbox
    mins = np.array([int(c.min()) for c in nz])
    maxs = np.array([int(c.max()) for c in nz])
    sl = tuple(slice(lo, hi + 1) for lo, hi in zip(mins, maxs))
    cropped = image[sl]
    cropped_label = label[sl] if label is not None else None
    return cropped, cropped_label, (mins, maxs)


def resample_image(
    image: np.ndarray,
    original_spacing: Sequence[float],
    target_spacing: Sequence[float],
) -> np.ndarray:
    """Axis-wise zoom with anisotropy-aware interpolation orders.

    Cubic (order 3) everywhere except the low-resolution axis of anisotropic
    volumes, which uses nearest (order 0) to avoid hallucinating structure
    between thick slices. Reference configuration.py:1105-1132.
    """
    original_spacing = np.asarray(original_spacing, dtype=np.float64)
    target_spacing = np.asarray(target_spacing, dtype=np.float64)
    if np.allclose(original_spacing, target_spacing):
        return image
    zoom_factors = original_spacing / target_spacing
    if is_anisotropic(original_spacing):
        lowres_axis = int(np.argmax(original_spacing))
        orders = [3 if i != lowres_axis else 0 for i in range(3)]
    else:
        orders = [3, 3, 3]
    out = image
    for axis in range(3):
        if zoom_factors[axis] != 1:
            zoom = [zoom_factors[axis] if i == axis else 1 for i in range(3)]
            out = ndimage.zoom(out, zoom=zoom, order=orders[axis])
    return out


def resample_label(
    label: np.ndarray,
    original_spacing: Sequence[float],
    target_spacing: Sequence[float],
) -> np.ndarray:
    """Label resampling via per-class one-hot + linear interp + argmax.

    Avoids nearest-neighbor label bleeding; uses order 0 on the low-res axis
    of anisotropic volumes. Reference configuration.py:1134-1158.
    """
    original_spacing = np.asarray(original_spacing, dtype=np.float64)
    target_spacing = np.asarray(target_spacing, dtype=np.float64)
    if np.allclose(original_spacing, target_spacing):
        return label
    zoom_factors = original_spacing / target_spacing
    unique = np.unique(label)
    unique = unique[unique != 0]
    if unique.size == 0:
        # background-only: just resample the zeros to the right shape
        zoomed = ndimage.zoom(label.astype(np.float32), zoom=zoom_factors, order=0)
        return zoomed.astype(np.uint8)

    if is_anisotropic(original_spacing):
        lowres_axis = int(np.argmax(original_spacing))
        orders = [1 if i != lowres_axis else 0 for i in range(3)]
    else:
        orders = [1, 1, 1]

    channels = []
    for cls in unique:
        chan = (label == cls).astype(np.float32)
        for axis in range(3):
            if zoom_factors[axis] != 1:
                zoom = [zoom_factors[axis] if i == axis else 1 for i in range(3)]
                chan = ndimage.zoom(chan, zoom=zoom, order=orders[axis])
        channels.append(chan)
    stacked = np.stack(channels, axis=0)
    # voxels where every class has ~zero support stay background
    argmax = np.argmax(stacked, axis=0)
    support = np.max(stacked, axis=0) > 0.5
    out = np.zeros(argmax.shape, dtype=np.uint8)
    for idx, cls in enumerate(unique):
        out[(argmax == idx) & support] = cls
    return out


def normalize_zscore_then_minmax(
    image: np.ndarray,
) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """Per-channel z-score then min-max to [0, 1]; records original min/max.

    The normalization actually used by the reference (configuration.py:1204-1221,
    selected at :1274 and :1402).
    """
    normalized = np.zeros_like(image, dtype=np.float32)
    min_max: List[Tuple[float, float]] = []
    for c in range(image.shape[0]):
        chan = image[c]
        vmin, vmax = float(np.min(chan)), float(np.max(chan))
        std = float(np.std(chan))
        z = (chan - np.mean(chan)) / (std if std > 0 else 1.0)
        z_min, z_max = float(np.min(z)), float(np.max(z))
        denom = (z_max - z_min) if z_max > z_min else 1.0
        normalized[c] = (z - z_min) / denom
        min_max.append((vmin, vmax))
    return normalized, min_max


def normalize_foreground_percentiles(
    image: np.ndarray, lower_p: float = 0.0, upper_p: float = 99.5
) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """Percentile-clip foreground (>0) per channel, preserve background=0
    (reference configuration.py:1170-1201; alternative normalization)."""
    normalized = np.zeros_like(image, dtype=np.float32)
    min_max: List[Tuple[float, float]] = []
    for c in range(image.shape[0]):
        chan = image[c]
        fg = chan > 0
        vals = chan[fg]
        if vals.size == 0:
            min_max.append((0.0, 1.0))
            continue
        vmin = float(np.percentile(vals, lower_p))
        vmax = float(np.percentile(vals, upper_p))
        denom = (vmax - vmin) if vmax > vmin else 1.0
        scaled = (np.clip(chan, vmin, vmax) - vmin) / denom
        normalized[c] = np.where(fg, scaled, 0.0)
        min_max.append((vmin, vmax))
    return normalized, min_max


def normalize_zscore_then_clip_then_minmax(
    image: np.ndarray, lower_p: float = 0.5, upper_p: float = 99.5
) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """z-score -> percentile clip -> min-max (reference
    configuration.py:1224-1244; alternative normalization)."""
    normalized = np.zeros_like(image, dtype=np.float32)
    min_max: List[Tuple[float, float]] = []
    for c in range(image.shape[0]):
        chan = image[c]
        vmin, vmax = float(np.min(chan)), float(np.max(chan))
        std = float(np.std(chan))
        z = (chan - np.mean(chan)) / (std if std > 0 else 1.0)
        z_min = float(np.percentile(z, lower_p))
        z_max = float(np.percentile(z, upper_p))
        denom = (z_max - z_min) if z_max > z_min else 1.0
        normalized[c] = (np.clip(z, z_min, z_max) - z_min) / denom
        min_max.append((vmin, vmax))
    return normalized, min_max


def to_canonical_axes(volume: np.ndarray) -> np.ndarray:
    """(X, Y, Z[, C]) NIfTI order -> (C, Z, Y, X) training order
    (reference configuration.py:1396-1399)."""
    if volume.ndim == 3:
        volume = volume[..., None]
    return np.transpose(volume, (3, 2, 1, 0))


def get_sampled_class_locations(
    label_array: np.ndarray,
    samples_per_slice: int = 50,
    rng: Optional[np.random.Generator] = None,
) -> Dict[int, List[Tuple[int, int, int]]]:
    """<=samples_per_slice foreground voxels per class per z-slice
    (reference configuration.py:1352-1380), vectorized per slice."""
    rng = rng or np.random.default_rng()
    class_locations: Dict[int, List[Tuple[int, int, int]]] = {}
    unique = np.unique(label_array)
    for lbl in unique:
        if lbl == 0:
            continue
        coords: List[Tuple[int, int, int]] = []
        for z in range(label_array.shape[0]):
            slice_coords = np.argwhere(label_array[z] == lbl)
            if slice_coords.shape[0] == 0:
                continue
            if slice_coords.shape[0] > samples_per_slice:
                idx = rng.choice(slice_coords.shape[0], samples_per_slice, replace=False)
                slice_coords = slice_coords[idx]
            coords.extend((int(z), int(y), int(x)) for y, x in slice_coords)
        class_locations[int(lbl)] = coords
    return class_locations


def save_properties(data_path: str, patient_id: str, properties: Dict) -> None:
    """Per-patient properties pickle (reference configuration.py:1030-1034)."""
    with open(os.path.join(data_path, f"{patient_id}.pkl"), "wb") as f:
        pickle.dump(properties, f)


def load_properties(data_path: str, patient_id: str) -> Dict:
    with open(os.path.join(data_path, f"{patient_id}.pkl"), "rb") as f:
        return pickle.load(f)


def process_patient(
    patient_id: str,
    images_path: str,
    labels_path: str,
    images_save_path: str,
    labels_save_path: str,
    median_spacing: Sequence[float],
    median_shape: Sequence[int],
) -> Dict:
    """Full per-patient preprocessing (reference configuration.py:1383-1430).

    Writes ``<id>.vs`` chunked-compressed image/label volumes plus a
    ``<id>.pkl`` properties file with class locations and intensity min/max.
    """
    log_lines = [f"Processing {patient_id}..."]
    image_path = os.path.join(images_path, patient_id + ".nii.gz")
    label_path = os.path.join(labels_path, patient_id + ".nii.gz")
    image_nii = load_nifti(image_path)
    label_nii = load_nifti(label_path) if os.path.exists(label_path) else None

    spacing = image_nii.spacing
    image = image_nii.get_fdata()
    label = label_nii.get_fdata() if label_nii is not None else None

    # NIfTI may be 4D (X,Y,Z,C); resample each channel independently
    if image.ndim == 4:
        resampled = np.stack(
            [resample_image(image[..., c], spacing, median_spacing) for c in range(image.shape[-1])],
            axis=-1,
        )
    else:
        resampled = resample_image(image, spacing, median_spacing)
    resampled_label = (
        resample_label(label.astype(np.int32), spacing, median_spacing)
        if label is not None
        else None
    )
    if not np.allclose(spacing, median_spacing):
        log_lines.append(
            f"    Resampled: spacing {np.round(spacing, 4).tolist()} -> "
            f"{np.round(np.asarray(median_spacing), 4).tolist()}"
        )

    crop_src = resampled if resampled.ndim == 3 else resampled[..., 0]
    _, _, (mins, maxs) = crop_to_nonzero(crop_src)
    sl = tuple(slice(int(lo), int(hi) + 1) for lo, hi in zip(mins, maxs))
    cropped = resampled[sl] if resampled.ndim == 3 else resampled[sl + (slice(None),)]
    cropped_label = resampled_label[sl] if resampled_label is not None else None
    log_lines.append(f"    Original size: {resampled.shape} - Cropped size: {cropped.shape}")

    image_czyx = to_canonical_axes(cropped).astype(np.float32)
    label_zyx = (
        np.transpose(cropped_label, (2, 1, 0)).astype(np.uint8)
        if cropped_label is not None
        else np.zeros(image_czyx.shape[1:], dtype=np.uint8)
    )

    normalized, min_max = normalize_zscore_then_minmax(image_czyx)

    image_chunks = (1, 1) + tuple(int(s) for s in median_shape[-2:])
    label_chunks = (1,) + tuple(int(s) for s in median_shape[-2:])
    image_save = os.path.join(images_save_path, patient_id + ".vs")
    label_save = os.path.join(labels_save_path, patient_id + ".vs")
    write_volume(image_save, normalized, chunk_shape=image_chunks, level=5)
    write_volume(label_save, label_zyx, chunk_shape=label_chunks, level=5)
    log_lines.append(f"    Saved processed image to {image_save}")
    log_lines.append(f"    Saved processed label to {label_save}")

    unique_labels = [int(v) for v in np.unique(label_zyx) if v != 0]
    class_locations = get_sampled_class_locations(label_zyx, samples_per_slice=50)
    save_properties(
        images_save_path,
        patient_id,
        {"class_locations": class_locations, "min_max": min_max},
    )

    return {
        "patient_id": patient_id,
        "shape": tuple(normalized.shape),
        "labels": unique_labels,
        "log": "\n".join(log_lines),
    }
