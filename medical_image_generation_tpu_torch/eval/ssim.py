"""SSIM / MS-SSIM for 2D and 3D channels-last images, on the card.

Port of ``medical_image_generation_tpu/eval/ssim.py`` (:19-163): the
structural similarity of the generative eval's diversity protocol, with the
JAX functions' arithmetic in fp32:

* the uniform filter is a running mean of ``win_size`` along each spatial
  axis (valid region), taken as the difference of a cumulative sum;
* ``ms_ssim`` uses as many of the five scales as the smallest side allows
  (halving it while it stays >= ``win_size``), renormalises their weights,
  clips each scale's SSIM to [1e-6, 1] before the log, and halves the images
  by 2x average pooling between scales;
* ``pairwise_metrics`` scores every one of the C(n, 2) pairs of a sample
  set in chunks of about 64M fp32 elements of gathered pairs; the tail
  chunk is padded with the last pair to the chunk's size and the padding
  trimmed afterwards, as the JAX function pads it for a single compiled
  program.

Tensors stay on their device; ``pairwise_metrics`` moves a numpy sample set
to the card unless the caller names another device.
"""

from __future__ import annotations

from itertools import combinations
from typing import Optional, Sequence

import numpy as np
import torch

from medical_image_generation_tpu_torch._device import resolve_device

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
_CHUNK_ELEMENTS = 64 << 20  # fp32 elements of gathered pairs a chunk


def _mean_axis(x: torch.Tensor, axis: int, win: int) -> torch.Tensor:
    """Running mean of size ``win`` along one axis (valid region), via cumsum."""
    c = torch.cumsum(x, dim=axis)
    zeros = torch.zeros_like(c.narrow(axis, 0, 1))
    c = torch.cat([zeros, c], dim=axis)
    n = c.shape[axis]
    return (c.narrow(axis, win, n - win) - c.narrow(axis, 0, n - win)) / win


def _uniform_filter(x: torch.Tensor, win: int, spatial_dims: int) -> torch.Tensor:
    """Separable mean filter over the spatial axes of (B, *spatial, C)."""
    x = x.float()
    for axis in range(1, 1 + spatial_dims):
        x = _mean_axis(x, axis, win)
    return x


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM per batch element; inputs (B, *spatial, C)."""
    spatial_dims = a.dim() - 2
    a, b = a.float(), b.float()
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    def f(t):
        return _uniform_filter(t, win_size, spatial_dims)

    mu_a, mu_b = f(a), f(b)
    mu_aa, mu_bb, mu_ab = f(a * a), f(b * b), f(a * b)
    var_a = mu_aa - mu_a ** 2
    var_b = mu_bb - mu_b ** 2
    cov = mu_ab - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    s = num / den
    return torch.mean(s, dim=tuple(range(1, s.dim())))


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x average pooling over the spatial axes (an odd last element dropped)."""
    for axis in range(1, x.dim() - 1):
        size = x.shape[axis] - x.shape[axis] % 2
        x = x.narrow(axis, 0, size)
        idx = torch.arange(0, size, 2, device=x.device)
        x = (x.index_select(axis, idx) + x.index_select(axis, idx + 1)) / 2
    return x


def num_scales(spatial: Sequence[int], win_size: int, n_weights: int = len(_MS_WEIGHTS)) -> int:
    """Scales ``ms_ssim`` uses: one more each time the smallest side halves
    and stays >= ``win_size``, at most ``n_weights``."""
    scales, m = 1, min(spatial)
    while m // 2 >= win_size and scales < n_weights:
        scales += 1
        m //= 2
    return scales


def ms_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, win_size: int = 7,
            weights: Sequence[float] = _MS_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM per batch element; scales limited so the window
    still fits."""
    n = num_scales(a.shape[1:-1], win_size, len(weights))
    w = torch.tensor(weights[:n], dtype=torch.float32, device=a.device)
    w = w / torch.sum(w)
    vals = []
    x, y = a, b
    for scale in range(n):
        vals.append(torch.clamp(ssim(x, y, data_range=data_range, win_size=win_size), 1e-6, 1.0))
        if scale < n - 1:
            x, y = _downsample2(x), _downsample2(y)
    vals = torch.stack(vals, dim=0)  # (scales, B)
    return torch.exp(torch.sum(w[:, None] * torch.log(vals), dim=0))


def pair_indices(n: int) -> np.ndarray:
    """(C(n, 2), 2) int64 pairs (i, j), i < j, in ``itertools.combinations`` order."""
    return np.asarray(list(combinations(range(n), 2)), np.int64).reshape(-1, 2)


def _chunk_pairs(n_pairs: int, image_shape: Sequence[int]) -> int:
    """Pairs a chunk gathers: about 64M fp32 elements of (a, b) pairs."""
    per_pair = 2 * int(np.prod(image_shape))
    return max(1, min(n_pairs, _CHUNK_ELEMENTS // max(per_pair, 1)))


@torch.no_grad()
def pairwise_metrics(images, win_size: int = 4, pairs_per_chunk: int = 0,
                     device: Optional[str | torch.device] = None) -> dict:
    """All-C(n, 2)-pairs SSIM and MS-SSIM over a sample set ``images``
    (n, *spatial, C), numpy or a tensor (which stays on its device).
    Returns the mean and std of both metrics (fp32 values, reduced on the
    host as the JAX function does) and ``n_pairs``."""
    if isinstance(images, torch.Tensor):
        imgs = images.float()
    else:
        imgs = torch.as_tensor(np.asarray(images, np.float32), device=resolve_device(device or "cuda"))
    idx = pair_indices(imgs.shape[0])
    n_pairs = len(idx)
    if n_pairs == 0:
        nan = float("nan")
        return {"ssim_mean": nan, "ssim_std": nan, "ms_ssim_mean": nan, "ms_ssim_std": nan,
                "n_pairs": 0}
    chunk = pairs_per_chunk or _chunk_pairs(n_pairs, imgs.shape[1:])
    padded = np.concatenate([idx, np.repeat(idx[-1:], (-n_pairs) % chunk, axis=0)])
    pairs = torch.from_numpy(padded).to(imgs.device)
    ssim_vals, ms_vals = [], []
    for start in range(0, len(padded), chunk):
        sl = pairs[start:start + chunk]
        a, b = imgs.index_select(0, sl[:, 0]), imgs.index_select(0, sl[:, 1])
        ssim_vals.append(ssim(a, b, win_size=win_size))
        ms_vals.append(ms_ssim(a, b, win_size=win_size))
    ssim_all = torch.cat(ssim_vals).cpu().numpy()[:n_pairs]
    ms_all = torch.cat(ms_vals).cpu().numpy()[:n_pairs]
    return {"ssim_mean": float(ssim_all.mean()), "ssim_std": float(ssim_all.std()),
            "ms_ssim_mean": float(ms_all.mean()), "ms_ssim_std": float(ms_all.std()),
            "n_pairs": int(n_pairs)}
