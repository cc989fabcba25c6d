"""Standalone dataset preprocessor: crop / resample / CLAHE to NIfTI files.

The port's own copy of ``medical_image_generation_tpu/planning/
standalone.py`` (:1-105), a capability match for the reference's legacy
``preprocess_dataset.py`` (its console script is commented out upstream,
pyproject.toml:39): a NIfTI -> NIfTI pipeline that crops to nonzero,
resamples to the dataset's median spacing, and optionally applies CLAHE
contrast adjustment, for preparing data outside the planning pipeline.
``python -m medical_image_generation_tpu_torch.planning.standalone``.

CLAHE runs per slice through OpenCV where it is installed, with a NumPy
global-equalisation fallback otherwise, as the JAX module does.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import os

import numpy as np

from medical_image_generation_tpu_torch.io.nifti import load_nifti, save_nifti
from medical_image_generation_tpu_torch.planning.fingerprint import calculate_median_spacing
from medical_image_generation_tpu_torch.planning.preprocess import (
    crop_to_nonzero,
    resample_image,
)

# OpenCV is optional; it is imported where CLAHE runs
_HAS_CV2 = importlib.util.find_spec("cv2") is not None


def adjust_contrast_clahe(volume: np.ndarray, clip_limit: float = 0.03) -> np.ndarray:
    """Slice-wise CLAHE, rescaled back to the original intensity range
    (reference preprocess_dataset.py:52-57)."""
    vmax = float(np.max(volume))
    if vmax <= 0:
        return volume
    norm = (volume / vmax * 65535.0).astype(np.uint16)
    if _HAS_CV2:
        import cv2

        clahe = cv2.createCLAHE(clipLimit=clip_limit * 256, tileGridSize=(8, 8))
        out = np.stack([clahe.apply(norm[..., z]) for z in range(norm.shape[-1])], axis=-1)
    else:  # global histogram equalization fallback
        hist, bins = np.histogram(norm.ravel(), bins=65536, range=(0, 65535))
        cdf = np.cumsum(hist).astype(np.float64)
        cdf = (cdf - cdf.min()) / max(cdf.max() - cdf.min(), 1)
        out = np.interp(norm.ravel(), bins[:-1], cdf * 65535).reshape(norm.shape)
    return out.astype(np.float32) / 65535.0 * vmax


def preprocess_dataset(
    dataset_path: str,
    output_path: str,
    crop: bool = True,
    resample: bool = True,
    contrast: bool = False,
) -> None:
    images_path = os.path.join(dataset_path, "imagesTr")
    paths = sorted(glob.glob(os.path.join(images_path, "*.nii.gz")))
    if not paths:
        raise FileNotFoundError(f"no .nii.gz under {images_path}")
    os.makedirs(output_path, exist_ok=True)

    median_spacing = calculate_median_spacing(paths) if resample else None
    if resample:
        print(f"Median spacing: {median_spacing}")

    for path in paths:
        name = os.path.basename(path)
        print(f"Processing {name}...")
        nii = load_nifti(path)
        data = nii.get_fdata()
        affine = nii.affine.copy()
        if resample:
            data = resample_image(data, nii.spacing, median_spacing)
            zoom = np.asarray(nii.spacing) / np.asarray(median_spacing)
            affine[:3, :3] = affine[:3, :3] / zoom[:, None]
        if crop:
            data, _, _ = crop_to_nonzero(data)
        if contrast:
            data = adjust_contrast_clahe(data)
        save_nifti(os.path.join(output_path, name), data.astype(np.float32), affine)


def main():
    parser = argparse.ArgumentParser(
        description="Standalone crop/resample/CLAHE preprocessing to NIfTI."
    )
    parser.add_argument("dataset_path", type=str)
    parser.add_argument("output_path", type=str)
    parser.add_argument("--no-crop", action="store_true")
    parser.add_argument("--no-resample", action="store_true")
    parser.add_argument("--contrast", action="store_true", help="Apply CLAHE")
    args = parser.parse_args()
    preprocess_dataset(
        args.dataset_path, args.output_path,
        crop=not args.no_crop, resample=not args.no_resample,
        contrast=args.contrast,
    )


if __name__ == "__main__":
    main()
