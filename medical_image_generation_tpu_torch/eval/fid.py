"""Frechet Inception Distance over arbitrary feature sets: the port's own copy.

Copied from ``medical_image_generation_tpu/eval/fid.py`` (:15-44), numpy on
the host in float64, as the JAX package computes it: FID between real and
synthetic feature distributions, the matrix square root from an
eigendecomposition of the symmetrized product (no scipy). The 2048 x 2048
``eigh`` stays on the host in float64; fp32 on the card would lose the
small eigenvalues the trace sums.
"""

from __future__ import annotations

import numpy as np


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh."""
    mat = (mat + mat.T) / 2
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    diff = mu1 - mu2
    # tr(sqrt(S1 S2)) computed stably: sqrt(S1) S2 sqrt(S1) is PSD
    s1_half = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    """FID between two (N, D) feature matrices."""
    real = np.asarray(real, dtype=np.float64)
    fake = np.asarray(fake, dtype=np.float64)
    mu_r, mu_f = real.mean(axis=0), fake.mean(axis=0)
    cov_r = np.cov(real, rowvar=False)
    cov_f = np.cov(fake, rowvar=False)
    # guard rank-deficient small-sample covariances
    eps = 1e-6
    cov_r = cov_r + eps * np.eye(cov_r.shape[0])
    cov_f = cov_f + eps * np.eye(cov_f.shape[0])
    return frechet_distance(mu_r, cov_r, mu_f, cov_f)
