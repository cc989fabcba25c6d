"""Batched device augmentation of the LDM train step, with every random
draw passed in.

Port of ``medical_image_generation_tpu/data/augment.py`` (``AugmentConfig``
:54-122, ``_augment_one`` :360-512, ``augment_batch`` :515-519): in-plane
rotation and scaling resampled onto the final grid from the (possibly
enlarged) input, mirror, multiplicative brightness, range-preserving
contrast, stats-retaining gamma, and the final clip to [0, 1]. The math is
fp32; the output has the input's dtype.

The JAX function draws its own numbers from a key; here the per-sample draws
are an ``AugmentDraws`` argument (the coins, the angle, the scale, the mirror
coins, the brightness / contrast / gamma factors), so a test can feed the
JAX step's own numbers. ``make_draws`` makes them from a CPU
``torch.Generator``: they are a few scalars a sample, and keeping them on the
host lets the per-sample branches run without waiting on the device.

The resample follows ``_bilinear_sample_plane`` / ``_rotate_scale_plane``
(:137-186) with explicit index gathers: the output grid is centred on the
input plane ((H - 1) / 2), mapped back by the inverse transform, and reads
outside the input are zero. ``F.grid_sample`` is not used: its
``align_corners`` conventions differ.

Not ported (they raise ``NotImplementedError``; the planner's flagship
config switches none of them on): the nnunet preset's 3D rotation
(``rot_3d``), gaussian noise, gaussian blur, simulated low resolution and
elastic deformation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from medical_image_generation_tpu_torch.data.patches import spatial_aug_params

P_ROT, P_SCALE, P_BRIGHT, P_CONTRAST, P_GAMMA = 0.2, 0.2, 0.15, 0.15, 0.3
_UNPORTED = ("gaussian_noise", "gaussian_blur", "low_resolution", "elastic")


@dataclass(frozen=True)
class AugmentConfig:
    rotation: bool = True
    scaling: bool = True
    mirror: bool = True
    brightness: bool = True
    contrast: bool = True
    gamma: bool = True
    gaussian_noise: bool = False
    gaussian_blur: bool = False
    low_resolution: bool = False
    dummy_2d: bool = False
    elastic: bool = False
    rot_range: float = 0.174533  # +-10 deg
    rot_3d: bool = False
    scale_range: Tuple[float, float] = (0.9, 1.1)
    bright_range: Tuple[float, float] = (0.9, 1.1)
    contrast_range: Tuple[float, float] = (0.9, 1.1)
    gamma_range: Tuple[float, float] = (0.9, 1.1)
    mirror_axes: Optional[Tuple[int, ...]] = None  # None -> x (last spatial)
    crop_to: Optional[Tuple[int, ...]] = None  # final spatial shape

    @staticmethod
    def from_transformations(t: Dict, spatial_dims: Optional[int] = None) -> "AugmentConfig":
        """The config of a transformations dict (the planner's
        ``ddpm_transformations``); ``spatial_dims`` trims a longer
        ``patch_size`` to the model's rank."""
        base = {k: t.get(k, d) for k, d in (
            ("rotation", True), ("scaling", True), ("mirror", True), ("brightness", True),
            ("contrast", True), ("gamma", True), ("gaussian_noise", False),
            ("gaussian_blur", False), ("low_resolution", False), ("dummy_2d", False),
            ("elastic", False))}
        if "patch_size" in t:
            patch = list(t["patch_size"])
            if spatial_dims is not None and len(patch) > spatial_dims:
                patch = patch[-spatial_dims:]
            geo = spatial_aug_params(t, patch)
            base.update(
                rot_range=geo["rot_range"], rot_3d=geo["rot_3d"],
                scale_range=tuple(geo["scale_range"]),
                bright_range=tuple(geo["bright_range"]),
                contrast_range=tuple(geo["contrast_range"]),
                gamma_range=tuple(geo["gamma_range"]),
                mirror_axes=tuple(geo["mirror_axes"]), crop_to=tuple(geo["patch_size"]),
                dummy_2d=geo["dummy_2d"] or base["dummy_2d"])
        return AugmentConfig(**base)


class AugmentDraws(NamedTuple):
    """Per-sample random draws of ``augment_batch``, batched on dim 0.
    Coins are bool; ``angle`` and ``scale`` are the drawn values, used only
    where their coin is on; ``flips`` is (B, n_mirror_axes)."""

    rot_on: torch.Tensor
    scale_on: torch.Tensor
    angle: torch.Tensor
    scale: torch.Tensor
    flips: torch.Tensor
    bright_on: torch.Tensor
    bright: torch.Tensor  # (B, C)
    contrast_on: torch.Tensor
    contrast: torch.Tensor  # (B, C)
    gamma_on: torch.Tensor
    gamma: torch.Tensor  # (B, C)


def _mirror_axes(cfg: AugmentConfig, n_spatial: int):
    return cfg.mirror_axes if cfg.mirror_axes is not None else (n_spatial - 1,)


def make_draws(cfg: AugmentConfig, batch: int, channels: int, n_spatial: int,
               generator: Optional[torch.Generator] = None) -> AugmentDraws:
    """Draws with the JAX function's distributions, from a CPU generator."""
    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((batch, *shape), generator=generator)

    rot_on = u() < P_ROT if (cfg.rotation and cfg.rot_range > 0) else torch.zeros(batch, dtype=bool)
    scale_on = u() < P_SCALE if cfg.scaling else torch.zeros(batch, dtype=bool)
    rr = float(cfg.rot_range)
    return AugmentDraws(
        rot_on=rot_on, scale_on=scale_on, angle=u(lo=-rr, hi=rr),
        scale=u(lo=cfg.scale_range[0], hi=cfg.scale_range[1]),
        flips=u(len(_mirror_axes(cfg, n_spatial))) < 0.5,
        bright_on=u() < P_BRIGHT, bright=u(channels, lo=cfg.bright_range[0],
                                           hi=cfg.bright_range[1]),
        contrast_on=u() < P_CONTRAST, contrast=u(channels, lo=cfg.contrast_range[0],
                                                 hi=cfg.contrast_range[1]),
        gamma_on=u() < P_GAMMA, gamma=u(channels, lo=cfg.gamma_range[0],
                                        hi=cfg.gamma_range[1]))


def _center(shape, out_spatial):
    """Slices of a center crop of the leading axes of ``shape`` to ``out_spatial``."""
    return tuple(slice((s - o) // 2, (s - o) // 2 + o) for s, o in zip(shape, out_spatial))


def _crop(img, out_spatial):
    """Center crop of the leading spatial axes of (..spatial.., C)."""
    return img[_center(img.shape, out_spatial)]


def center_crop_batch(batch, spatial):
    """Center crop of a channels-last batch (B, *spatial_in, C) down to
    (B, *spatial, C); identity when the shapes already match."""
    return batch[(slice(None),) + _center(batch.shape[1:], spatial)]


def _bilinear_sample_plane(img, src_y, src_x):
    """Bilinear gather of (..., Y, X, C) at fractional (Ho, Wo) plane
    coordinates; reads outside the plane are zero."""
    H, W = img.shape[-3], img.shape[-2]
    y0f, x0f = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0f)[..., None], (src_x - x0f)[..., None]
    y0, x0 = y0f.long(), x0f.long()

    def gather(yi, xi):
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))[..., None]
        vals = img[..., yi.clamp(0, H - 1), xi.clamp(0, W - 1), :]
        return torch.where(valid, vals, torch.zeros((), dtype=img.dtype, device=img.device))

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _rotate_scale_plane(img, angle: float, scale: float, out_hw):
    """In-plane (Y, X) rotation + scale of one (..., Y, X, C) sample onto an
    ``out_hw`` grid centred on the input plane."""
    H, W = img.shape[-3], img.shape[-2]
    Ho, Wo = out_hw
    dev = img.device
    ys = torch.arange(Ho, dtype=torch.float32, device=dev) - (Ho - 1) / 2.0
    xs = torch.arange(Wo, dtype=torch.float32, device=dev) - (Wo - 1) / 2.0
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    a = torch.tensor(angle, dtype=torch.float32)
    cos, sin = float(torch.cos(a)), float(torch.sin(a))
    inv = float(1.0 / torch.tensor(scale, dtype=torch.float32))
    src_y = (cos * yy + sin * xx) * inv + (H - 1) / 2.0
    src_x = (-sin * yy + cos * xx) * inv + (W - 1) / 2.0
    return _bilinear_sample_plane(img, src_y, src_x)


def _augment_one(img, d: AugmentDraws, i: int, cfg: AugmentConfig):
    orig_dtype = img.dtype
    img = img.float()
    n_spatial = img.dim() - 1
    out_spatial = tuple(cfg.crop_to) if cfg.crop_to is not None else tuple(img.shape[:-1])
    if len(out_spatial) != n_spatial:
        raise ValueError(f"crop_to {out_spatial} rank does not match sample spatial rank "
                         f"{n_spatial} (shape {tuple(img.shape)})")
    if any(o > s for o, s in zip(out_spatial, img.shape)):
        raise ValueError(f"crop_to {out_spatial} larger than input {tuple(img.shape)}")

    rot_on, scale_on = bool(d.rot_on[i]), bool(d.scale_on[i])
    if rot_on or scale_on:
        # z carries no spatial transform: crop it, then sample the final
        # (Y, X) grid from the (possibly enlarged) plane
        img = _crop(img, out_spatial[:-2] + tuple(img.shape[n_spatial - 2:n_spatial]))
        img = _rotate_scale_plane(img, float(d.angle[i]) if rot_on else 0.0,
                                  float(d.scale[i]) if scale_on else 1.0, out_spatial[-2:])
    else:
        img = _crop(img, out_spatial)

    if cfg.mirror:
        for j, ax in enumerate(_mirror_axes(cfg, n_spatial)):
            if bool(d.flips[i, j]):
                img = torch.flip(img, dims=(ax,))

    axes = tuple(range(n_spatial))
    if cfg.brightness and bool(d.bright_on[i]):
        img = img * d.bright[i].to(img.device, torch.float32)
    if cfg.contrast and bool(d.contrast_on[i]):
        f = d.contrast[i].to(img.device, torch.float32)
        mean = img.mean(dim=axes, keepdim=True)
        mn, mx = img.amin(dim=axes, keepdim=True), img.amax(dim=axes, keepdim=True)
        img = torch.minimum(torch.maximum((img - mean) * f + mean, mn), mx)
    if cfg.gamma and bool(d.gamma_on[i]):
        g = d.gamma[i].to(img.device, torch.float32)
        mean = img.mean(dim=axes, keepdim=True)
        std = img.std(dim=axes, keepdim=True, correction=0) + 1e-7
        mn = img.amin(dim=axes, keepdim=True)
        rng = img.amax(dim=axes, keepdim=True) - mn + 1e-7
        gammaed = torch.pow(((img - mn) / rng).clamp(1e-7, 1.0), g) * rng + mn
        gmean = gammaed.mean(dim=axes, keepdim=True)
        gstd = gammaed.std(dim=axes, keepdim=True, correction=0) + 1e-7
        img = (gammaed - gmean) / gstd * std + mean
    return img.clamp(0.0, 1.0).to(orig_dtype)


def check_ported(cfg: AugmentConfig, n_spatial: int) -> None:
    """Raise ``NotImplementedError`` if ``cfg`` switches on an augmentation
    the port lacks (the trainer calls this before its first step)."""
    on = [k for k in _UNPORTED if getattr(cfg, k)]
    if cfg.rot_3d and n_spatial == 3 and not cfg.dummy_2d:
        on.append("rot_3d")
    if on:
        raise NotImplementedError(f"augmentations not ported yet: {on}")


def augment_batch(batch, draws: AugmentDraws, cfg: AugmentConfig):
    """Augment a channels-last batch (B, *spatial_in, C) with the given
    draws; returns (B, *crop_to, C) (or the input's spatial shape)."""
    check_ported(cfg, batch.dim() - 2)
    return torch.stack([_augment_one(batch[i], draws, i, cfg) for i in range(batch.shape[0])])
