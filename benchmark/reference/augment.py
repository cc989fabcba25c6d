"""Plain float32 augmentation of one training batch with given draws: the
planner's "soft" preset (rotation and scaling in the (Y, X) plane, sampled
onto the final patch, else a centre crop; mirror; multiplicative brightness;
range-preserving contrast; statistics-retaining gamma; clip to [0, 1]),
written from the reference project's transforms. The diffusion preset's
rotation range is 0; the optional transforms (noise, blur, elastic, low
resolution, 3D rotation) are not written here."""

from __future__ import annotations

import torch


def _crop(img, out):
    return img[tuple(slice((s - o) // 2, (s - o) // 2 + o) for s, o in zip(img.shape, out))]


def _rotate_scale_plane(img, angle: float, scale: float, out_hw):
    """Rotation and scale about the plane's centre, sampled bilinearly onto
    an ``out_hw`` grid centred on the input (output coordinates mapped back
    by the inverse transform); reads outside are zero. img (..., Y, X, C)."""
    H, W = img.shape[-3], img.shape[-2]
    a = torch.tensor(angle, dtype=torch.float32)
    cos, sin = float(torch.cos(a)), float(torch.sin(a))
    inv = float(1.0 / torch.tensor(scale, dtype=torch.float32))
    oy, ox = torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=img.device) - (n - 1) / 2.0
          for n in out_hw], indexing="ij")
    sy = (cos * oy + sin * ox) * inv + (H - 1) / 2.0
    sx = (-sin * oy + cos * ox) * inv + (W - 1) / 2.0
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0f)[..., None], (sx - x0f)[..., None]
    y0, x0 = y0f.long(), x0f.long()

    def at(yi, xi):
        ok = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))[..., None]
        return torch.where(ok, img[..., yi.clamp(0, H - 1), xi.clamp(0, W - 1), :], 0.0)

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def augment(batch, d: dict, aug: dict):
    """batch (B, *spatial_in, C) fp32 -> (B, *crop_to, C)."""
    out = []
    crop = tuple(aug["crop_to"])
    for i in range(batch.shape[0]):
        img = batch[i].float()
        ns = img.dim() - 1
        axes = tuple(range(ns))
        rot = "rot_on" in d and bool(d["rot_on"][i])
        if rot or bool(d["scale_on"][i]):
            img = _crop(img, crop[:-2] + tuple(img.shape[ns - 2:ns]))
            img = _rotate_scale_plane(img, float(d["angle"][i]) if rot else 0.0,
                                      float(d["scale"][i]) if bool(d["scale_on"][i]) else 1.0,
                                      crop[-2:])
        else:
            img = _crop(img, crop)
        for j, ax in enumerate(aug["mirror_axes"]):
            if bool(d["flips"][i, j]):
                img = torch.flip(img, dims=(ax,))
        if bool(d["bright_on"][i]):
            img = img * d["bright"][i].to(img.device)
        if bool(d["contrast_on"][i]):
            f = d["contrast"][i].to(img.device)
            mean = img.mean(dim=axes, keepdim=True)
            lo, hi = img.amin(dim=axes, keepdim=True), img.amax(dim=axes, keepdim=True)
            img = torch.minimum(torch.maximum((img - mean) * f + mean, lo), hi)
        if bool(d["gamma_on"][i]):
            g = d["gamma"][i].to(img.device)
            mean = img.mean(dim=axes, keepdim=True)
            std = img.std(dim=axes, keepdim=True, correction=0) + 1e-7
            lo = img.amin(dim=axes, keepdim=True)
            rng = img.amax(dim=axes, keepdim=True) - lo + 1e-7
            ga = torch.pow(((img - lo) / rng).clamp(1e-7, 1.0), g) * rng + lo
            img = ((ga - ga.mean(dim=axes, keepdim=True))
                   / (ga.std(dim=axes, keepdim=True, correction=0) + 1e-7) * std + mean)
        out.append(img.clamp(0.0, 1.0))
    return torch.stack(out)
