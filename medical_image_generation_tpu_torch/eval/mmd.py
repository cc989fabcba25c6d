"""Maximum Mean Discrepancy over feature sets: the port's own copy.

Copied from ``medical_image_generation_tpu/eval/mmd.py`` (:13-40): the
unbiased Gaussian-kernel MMD^2 with the median-heuristic bandwidth, numpy
on the host in float64, as the JAX package computes it.
"""

from __future__ import annotations

import numpy as np


def mmd_from_features(real: np.ndarray, fake: np.ndarray,
                      bandwidth: float | None = None) -> float:
    """Unbiased Gaussian-kernel MMD^2 between (N, D) feature matrices."""
    x = np.asarray(real, dtype=np.float64)
    y = np.asarray(fake, dtype=np.float64)

    def sq_dists(a, b):
        return (
            np.sum(a**2, axis=1)[:, None]
            - 2.0 * a @ b.T
            + np.sum(b**2, axis=1)[None, :]
        )

    dxx, dyy, dxy = sq_dists(x, x), sq_dists(y, y), sq_dists(x, y)
    if bandwidth is None:
        all_d = np.concatenate([dxx.ravel(), dyy.ravel(), dxy.ravel()])
        med = np.median(all_d[all_d > 0]) if np.any(all_d > 0) else 1.0
        bandwidth = np.sqrt(med / 2.0) or 1.0

    g = 1.0 / (2.0 * bandwidth**2)
    kxx, kyy, kxy = np.exp(-g * dxx), np.exp(-g * dyy), np.exp(-g * dxy)

    n, m = len(x), len(y)
    np.fill_diagonal(kxx, 0.0)
    np.fill_diagonal(kyy, 0.0)
    term_x = kxx.sum() / (n * (n - 1)) if n > 1 else 0.0
    term_y = kyy.sum() / (m * (m - 1)) if m > 1 else 0.0
    return float(term_x + term_y - 2.0 * kxy.mean())
