"""Batched device augmentation of the diffusion and stage-1 train steps,
with every random draw passed in.

Port of ``medical_image_generation_tpu/data/augment.py`` (``AugmentConfig``
:54-122, ``_augment_one`` :360-512, ``augment_batch`` :515-519): rotation and
scaling resampled onto the final grid from the (possibly enlarged) input (in
the (Y, X) plane, or about all three axes under the nnunet preset's
``rot_3d``), mirror, gaussian noise, elastic deformation, gaussian blur,
simulated low resolution, multiplicative brightness, range-preserving
contrast, stats-retaining gamma, and the final clip to [0, 1], in that
order. The math is fp32; the output has the input's dtype.

The JAX function draws its own numbers from a key; here the per-sample draws
are an ``AugmentDraws`` argument, so a test can feed the JAX step's own
numbers. ``make_draws`` makes them: every coin and every scalar (angles,
scale, noise variance, elastic magnitude, blur sigma, low-resolution scales)
from a CPU ``torch.Generator``, so the per-sample branches run without
waiting on the device; the two fields (the image-sized noise and the (2, 4,
4) coarse elastic offsets) from ``field_generator``, which the trainers give
as their device generator, so a noise field of a whole batch is never drawn
on the host and copied.

The resamples follow ``_bilinear_sample_plane`` / ``_rotate_scale_plane``
(:137-186) and ``_trilinear_sample`` / ``_rotate_scale_3d`` (:212-273) with
explicit index gathers: the output grid is centred on the input ((n - 1) /
2 on every axis), mapped back by the inverse transform, and reads outside
the input are zero. ``F.grid_sample`` is not used: its ``align_corners``
conventions differ. The elastic field's bilinear upsample is written out as
``jax.image.resize`` computes it (half-pixel centres, triangle weights
normalised by their sum), and the blur rolls as ``jnp.roll`` does (it wraps
around the plane).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from medical_image_generation_tpu_torch.data.patches import spatial_aug_params

P_ROT, P_SCALE, P_BRIGHT, P_CONTRAST, P_GAMMA = 0.2, 0.2, 0.15, 0.15, 0.3
P_NOISE, P_BLUR, P_LOWRES, P_ELASTIC = 0.1, 0.2, 0.25, 0.2
NOISE_VAR = (0.0, 0.1)
BLUR_SIGMA = (0.5, 1.0)
LOWRES_SCALE = (0.5, 1.0)  # reference data_processing.py:814
ELASTIC_MAX_FRAC = 0.08  # max displacement as a fraction of the plane size
ELASTIC_GRID = 4  # the coarse displacement field is (2, 4, 4)


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
    Coins are bool; every value is used only where its coin is on. The
    draws of a transform the config leaves off may be None."""

    rot_on: torch.Tensor
    scale_on: torch.Tensor
    angle: torch.Tensor
    scale: torch.Tensor
    flips: torch.Tensor  # (B, n_mirror_axes)
    bright_on: torch.Tensor
    bright: torch.Tensor  # (B, C)
    contrast_on: torch.Tensor
    contrast: torch.Tensor  # (B, C)
    gamma_on: torch.Tensor
    gamma: torch.Tensor  # (B, C)
    angles3: Optional[torch.Tensor] = None  # (B, 3), about (z, y, x) under rot_3d
    noise_on: Optional[torch.Tensor] = None
    noise_var: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None  # (B, *final spatial, C) standard normals
    elastic_on: Optional[torch.Tensor] = None
    elastic_mag: Optional[torch.Tensor] = None  # uniform in [0, ELASTIC_MAX_FRAC)
    elastic_field: Optional[torch.Tensor] = None  # (B, 2, 4, 4) standard normals
    blur_on: Optional[torch.Tensor] = None
    blur_sigma: Optional[torch.Tensor] = None
    lowres_on: Optional[torch.Tensor] = None
    lowres_scale: Optional[torch.Tensor] = None  # (B, C)
    lowres_chan_on: Optional[torch.Tensor] = None  # (B, C)


def _mirror_axes(cfg: AugmentConfig, n_spatial: int):
    return cfg.mirror_axes if cfg.mirror_axes is not None else (n_spatial - 1,)


def _use_3d(cfg: AugmentConfig, n_spatial: int) -> bool:
    return cfg.rot_3d and n_spatial == 3 and not cfg.dummy_2d


def make_draws(cfg: AugmentConfig, batch: int, channels: int, n_spatial: int,
               generator: Optional[torch.Generator] = None,
               field_generator: Optional[torch.Generator] = None,
               spatial: Optional[Tuple[int, ...]] = None) -> AugmentDraws:
    """Draws with the JAX function's distributions: the scalars from the CPU
    ``generator``, the noise and elastic fields from ``field_generator`` on
    its device (default: ``generator``). ``spatial``, the input's spatial
    shape, sizes the noise field when ``cfg.crop_to`` does not; only the
    transforms ``cfg`` switches on are drawn."""
    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((batch, *shape), generator=generator)

    fgen = field_generator or generator
    fdev = fgen.device if fgen is not None else torch.device("cpu")

    def normal(*shape):
        return torch.randn((batch, *shape), generator=fgen, device=fdev)

    rot_on = u() < P_ROT if (cfg.rotation and cfg.rot_range > 0) else torch.zeros(batch, dtype=bool)
    scale_on = u() < P_SCALE if cfg.scaling else torch.zeros(batch, dtype=bool)
    rr = float(cfg.rot_range)
    extra = {}
    if _use_3d(cfg, n_spatial):
        extra.update(angles3=u(3, lo=-rr, hi=rr))
    if cfg.gaussian_noise:
        out = cfg.crop_to if cfg.crop_to is not None else spatial
        if out is None:
            raise ValueError("gaussian_noise needs the final spatial shape: set crop_to or "
                             "pass spatial")
        extra.update(noise_on=u() < P_NOISE, noise_var=u(lo=NOISE_VAR[0], hi=NOISE_VAR[1]),
                     noise=normal(*out, channels))
    if cfg.elastic:
        extra.update(elastic_on=u() < P_ELASTIC, elastic_mag=u(hi=ELASTIC_MAX_FRAC),
                     elastic_field=normal(2, ELASTIC_GRID, ELASTIC_GRID))
    if cfg.gaussian_blur:
        extra.update(blur_on=u() < P_BLUR, blur_sigma=u(lo=BLUR_SIGMA[0], hi=BLUR_SIGMA[1]))
    if cfg.low_resolution:
        extra.update(lowres_on=u() < P_LOWRES,
                     lowres_scale=u(channels, lo=LOWRES_SCALE[0], hi=LOWRES_SCALE[1]),
                     lowres_chan_on=u(channels) < 0.5)
    return AugmentDraws(
        rot_on=rot_on, scale_on=scale_on, angle=u(lo=-rr, hi=rr),
        scale=u(lo=cfg.scale_range[0], hi=cfg.scale_range[1]),
        flips=u(len(_mirror_axes(cfg, n_spatial))) < 0.5,
        bright_on=u() < P_BRIGHT, bright=u(channels, lo=cfg.bright_range[0],
                                           hi=cfg.bright_range[1]),
        contrast_on=u() < P_CONTRAST, contrast=u(channels, lo=cfg.contrast_range[0],
                                                 hi=cfg.contrast_range[1]),
        gamma_on=u() < P_GAMMA, gamma=u(channels, lo=cfg.gamma_range[0],
                                        hi=cfg.gamma_range[1]),
        **extra)


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


def _f32(v) -> float:
    """``v`` rounded to fp32, as a Python float (exact)."""
    return float(torch.as_tensor(v, dtype=torch.float32))


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


def _centred_grid(shape, device):
    """Coordinates of an output grid centred on its middle ((n - 1) / 2),
    fp32, one (*shape) tensor an axis."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0 for n in shape]
    return torch.meshgrid(*axes, indexing="ij")


def _rotate_scale_plane(img, angle: float, scale: float, out_hw):
    """In-plane (Y, X) rotation + scale of one (..., Y, X, C) sample onto an
    ``out_hw`` grid centred on the input plane."""
    H, W = img.shape[-3], img.shape[-2]
    yy, xx = _centred_grid(out_hw, img.device)
    a = torch.tensor(angle, dtype=torch.float32)
    cos, sin = float(torch.cos(a)), float(torch.sin(a))
    inv = float(1.0 / torch.tensor(scale, dtype=torch.float32))
    src_y = (cos * yy + sin * xx) * inv + (H - 1) / 2.0
    src_x = (-sin * yy + cos * xx) * inv + (W - 1) / 2.0
    return _bilinear_sample_plane(img, src_y, src_x)


def _trilinear_sample(img, src_z, src_y, src_x):
    """Trilinear gather of (Z, Y, X, C) at fractional coordinates (each of
    the output grid's shape); reads outside the volume are zero. The eight
    corners are summed in the JAX function's order."""
    Z, Y, X = img.shape[:3]
    z0f, y0f, x0f = torch.floor(src_z), torch.floor(src_y), torch.floor(src_x)
    wz, wy, wx = ((s - f)[..., None] for s, f in ((src_z, z0f), (src_y, y0f), (src_x, x0f)))
    z0, y0, x0 = z0f.long(), y0f.long(), x0f.long()
    zero = torch.zeros((), dtype=img.dtype, device=img.device)

    def gather(zi, yi, xi):
        valid = ((zi >= 0) & (zi < Z) & (yi >= 0) & (yi < Y) & (xi >= 0) & (xi < X))[..., None]
        vals = img[zi.clamp(0, Z - 1), yi.clamp(0, Y - 1), xi.clamp(0, X - 1), :]
        return torch.where(valid, vals, zero)

    out = None
    for dz, fz in ((0, 1 - wz), (1, wz)):
        for dy, fy in ((0, 1 - wy), (1, wy)):
            for dx, fx in ((0, 1 - wx), (1, wx)):
                term = fz * fy * fx * gather(z0 + dz, y0 + dy, x0 + dx)
                out = term if out is None else out + term
    return out


def _rotation_3d(angles) -> torch.Tensor:
    """R = Rx Ry Rz (fp32, (3, 3)) of ``angles`` (about z, y, x: the first
    turns the (y, x) plane), as the JAX ``_rotate_scale_3d`` composes it."""
    c, s = torch.cos(angles.float()), torch.sin(angles.float())
    mats = []
    for axis in range(3):
        R = torch.eye(3, dtype=torch.float32)
        i, j = [d for d in range(3) if d != axis]
        R[i, i], R[i, j], R[j, i], R[j, j] = c[axis], -s[axis], s[axis], c[axis]
        mats.append(R)
    return mats[0] @ mats[1] @ mats[2]


def _rotate_scale_3d(img, angles, scale: float, out_zyx):
    """Rotation about all three axes plus a synchronised scale of one (Z, Y,
    X, C) sample onto an ``out_zyx`` grid centred on the input; R's
    transpose is its inverse."""
    Z, Y, X = img.shape[:3]
    rinv = _rotation_3d(torch.as_tensor(angles)).T.tolist()
    inv = float(1.0 / torch.tensor(scale, dtype=torch.float32))
    zz, yy, xx = _centred_grid(out_zyx, img.device)
    src = [(r[0] * zz + r[1] * yy + r[2] * xx) * inv + (n - 1) / 2.0
           for r, n in zip(rinv, (Z, Y, X))]
    return _trilinear_sample(img, *src)


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., "bilinear")`` along
    one axis: half-pixel sample positions, triangle weights normalised by
    their sum, zero where a sample falls outside the input."""
    inv = _f32(1.0 / (n_out / n_in))
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = (1.0 - (sample[None, :] - src[:, None]).abs()).clamp_min(0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(plane, out_hw) -> torch.Tensor:
    """``jax.image.resize(plane, out_hw, "bilinear")`` of a 2D fp32 plane."""
    wy = resize_weights(plane.shape[0], out_hw[0], plane.device)
    wx = resize_weights(plane.shape[1], out_hw[1], plane.device)
    return wy.T @ plane @ wx


def _elastic_plane(img, mag_u: float, field):
    """Smooth in-plane displacement of every (Y, X) plane of a (..., Y, X,
    C) sample: the coarse (2, 4, 4) ``field`` upsampled bilinearly to the
    plane, times ``mag_u * min(H, W)``, added to the sampling coordinates."""
    H, W = img.shape[-3], img.shape[-2]
    mag = _f32(mag_u) * min(H, W)
    field = field.to(img.device, torch.float32)
    dy = resize_bilinear(field[0], (H, W)) * mag
    dx = resize_bilinear(field[1], (H, W)) * mag
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device),
                            indexing="ij")
    return _bilinear_sample_plane(img, yy + dy, xx + dx)


def _axis_lowres(x, s: float, axis: int):
    """Simulated low resolution along one axis as one composed resample:
    nearest down to N * s, then linear back up (the JAX ``_axis_lowres``;
    ``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    N = x.shape[axis]
    i = torch.arange(N, dtype=torch.float32, device=x.device)
    jf = (i + 0.5) * s - 0.5
    j0 = torch.floor(jf)
    w = jf - j0

    def src(j):
        return torch.round((j + 0.5) / s - 0.5).clamp(0, N - 1).long()

    a = x.index_select(axis, src(j0))
    b = x.index_select(axis, src(j0 + 1))
    shape = [1] * x.dim()
    shape[axis] = N
    w = w.reshape(shape)
    return a * (1 - w) + b * w


def _simulate_lowres(img, scales, chan_on, dummy_2d: bool):
    """Per channel with its coin on: the same scale on every spatial axis
    of a (*spatial, C) sample, z left alone under ``dummy_2d`` in 3D."""
    skip_z = dummy_2d and img.dim() == 4
    chans = []
    for c in range(img.shape[-1]):
        ch = img[..., c]
        if bool(chan_on[c]):
            s = _f32(scales[c])
            for ax in range(ch.dim()):
                if not (skip_z and ax == 0):
                    ch = _axis_lowres(ch, s, ax)
        chans.append(ch)
    return torch.stack(chans, dim=-1)


def _blur5(img, sigma: float):
    """Separable 5-tap Gaussian blur over the trailing (Y, X) axes of (...,
    Y, X, C), sigma floored at 1e-3; the taps wrap around (``jnp.roll``)."""
    offsets = torch.arange(-2, 3, dtype=torch.float32)
    k = torch.exp(-0.5 * (offsets / max(_f32(sigma), 1e-3)) ** 2)
    k = (k / k.sum()).tolist()

    def conv_axis(x, axis):
        out = None
        for kk, o in zip(k, range(-2, 3)):
            term = kk * torch.roll(x, -o, dims=axis)
            out = term if out is None else out + term
        return out

    return conv_axis(conv_axis(img, img.dim() - 3), img.dim() - 2)


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
    scale = float(d.scale[i]) if scale_on else 1.0
    if (rot_on or scale_on) and _use_3d(cfg, n_spatial):
        angles = d.angles3[i] if rot_on else torch.zeros(3)
        img = _rotate_scale_3d(img, angles, scale, out_spatial)
    elif rot_on or scale_on:
        # z carries no spatial transform: crop it, then sample the final
        # (Y, X) grid from the (possibly enlarged) plane
        img = _crop(img, out_spatial[:-2] + tuple(img.shape[n_spatial - 2:n_spatial]))
        img = _rotate_scale_plane(img, float(d.angle[i]) if rot_on else 0.0, scale,
                                  out_spatial[-2:])
    else:
        img = _crop(img, out_spatial)

    if cfg.mirror:
        for j, ax in enumerate(_mirror_axes(cfg, n_spatial)):
            if bool(d.flips[i, j]):
                img = torch.flip(img, dims=(ax,))

    if cfg.gaussian_noise and bool(d.noise_on[i]):
        std = float(torch.sqrt(d.noise_var[i].float()))
        img = img + d.noise[i].to(img.device, torch.float32) * std
    if cfg.elastic and bool(d.elastic_on[i]):
        img = _elastic_plane(img, float(d.elastic_mag[i]), d.elastic_field[i])
    if cfg.gaussian_blur and bool(d.blur_on[i]):
        img = _blur5(img, float(d.blur_sigma[i]))
    if cfg.low_resolution and bool(d.lowres_on[i]):
        img = _simulate_lowres(img, d.lowres_scale[i], d.lowres_chan_on[i], cfg.dummy_2d)

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


def augment_batch(batch, draws: AugmentDraws, cfg: AugmentConfig):
    """Augment a channels-last batch (B, *spatial_in, C) with the given
    draws; returns (B, *crop_to, C) (or the input's spatial shape)."""
    return torch.stack([_augment_one(batch[i], draws, i, cfg) for i in range(batch.shape[0])])
