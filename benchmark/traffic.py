"""The benchmark's one generator of training traffic, read from a workload
file: a pool of loader batches and a pool of per-step random draws, every
number made from ``--seed``.

Batches are smooth random volumes (or slices) in [0, 1]: a coarse normal grid
upsampled to the loader's (enlarged) patch plus fine noise, made on the card
in one call and handed to the window as host arrays, as the loader hands them.
Draws follow the distributions of the training step's augmentation and
diffusion: per-sample coins and scalars on the host, timesteps on the host,
the posterior noise and the diffusion noise on the card. Each augmentation's
coin comes up on the same number of the pool's rows for every seed (its
probability times the rows, rounded), at rows the seed picks: the program
augments row by row, so a seed that drew more coins would do more work.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_MASK = (1 << 63) - 1


def seed_of(seed: int, *salt: int) -> int:
    """A 63-bit generator seed from the run's seed (any size) and a salt."""
    h = int(seed) & ((1 << 64) - 1)
    for s in salt:
        h = (h * 6364136223846793005 + 1442695040888963407 + int(s)) & ((1 << 64) - 1)
    return h & _MASK


def generator(device, seed: int, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, *salt))


def batches(work: dict, seed: int, device) -> list:
    """``work["pool"]`` batches (B, *initial_patch, C) of fp32 numpy arrays
    in [0, 1]."""
    img = work["images"]
    B, C, shape = work["batch"], img["channels"], tuple(img["initial_patch"])
    n = work["pool"]
    gen = generator(device, seed, 1)
    coarse = torch.randn((n * B * C, 1, *img["coarse"]), generator=gen, device=device)
    mode = "trilinear" if len(shape) == 3 else "bilinear"
    vol = F.interpolate(coarse, size=shape, mode=mode, align_corners=False)
    vol = vol + img["fine_noise"] * torch.randn(vol.shape, generator=gen, device=device)
    vol = torch.sigmoid(vol).reshape(n, B, C, *shape).movedim(2, -1)
    host = vol.float().cpu().numpy()
    return [np.ascontiguousarray(host[i]) for i in range(n)]


def latent_shape(work: dict):
    """(*latent spatial, latent channels) of the cell's final patch."""
    lat = work["latent"]
    return tuple(lat["spatial"]) + (lat["channels"],)


def coins(n: int, B: int, p: float, gen: torch.Generator):
    """(n, B) booleans, exactly round(p n B) of them set, at rows that a
    permutation drawn from ``gen`` picks."""
    on = torch.zeros(n * B, dtype=torch.bool)
    on[torch.randperm(n * B, generator=gen)[:round(p * n * B)]] = True
    return on.view(n, B)


def draws(work: dict, seed: int, device) -> list:
    """``work["pool"]`` draws, each a dict: ``augment`` (per-sample coins and
    scalars, host), ``eps`` and ``noise`` (card, (B, *latent)), ``t`` (host
    int64)."""
    aug, B = work["augment"], work["batch"]
    C = work["images"]["channels"]
    T = work["timesteps"]
    lat = latent_shape(work)
    n, p = work["pool"], aug["p"]
    pick = generator("cpu", seed, 6)
    on = {name: coins(n, B, p[name], pick) for name in ("scale", "bright", "contrast", "gamma")}
    flips = torch.stack([coins(n, B, 0.5, pick) for _ in aug["mirror_axes"]], dim=-1)
    out = []
    for k in range(n):
        host = generator("cpu", seed, 2, k)
        dev = generator(device, seed, 3, k)

        def u(*shape, lo=0.0, hi=1.0):
            return lo + (hi - lo) * torch.rand((B, *shape), generator=host)

        a = dict(
            scale_on=on["scale"][k], scale=u(lo=aug["scale_range"][0], hi=aug["scale_range"][1]),
            flips=flips[k],
            bright_on=on["bright"][k], bright=u(C, lo=aug["bright_range"][0],
                                                hi=aug["bright_range"][1]),
            contrast_on=on["contrast"][k], contrast=u(C, lo=aug["contrast_range"][0],
                                                      hi=aug["contrast_range"][1]),
            gamma_on=on["gamma"][k], gamma=u(C, lo=aug["gamma_range"][0],
                                             hi=aug["gamma_range"][1]))
        out.append(dict(
            augment=a,
            eps=torch.randn((B, *lat), generator=dev, device=device),
            t=torch.randint(0, T, (B,), generator=host),
            noise=torch.randn((B, *lat), generator=dev, device=device)))
    return out


def probe_generator(work: dict, seed: int, device) -> torch.Generator:
    """The generator of the latent probe's posterior noise."""
    return generator(device, seed, 4)


def weights(named_shapes, norm_names, seed: int, salt: int, device) -> dict:
    """Seeded fp32 weights for ``named_shapes`` [(name, shape)], drawn in one
    call on ``device``: weights of two or more dims n / sqrt(fan_in), biases
    0.02 n, the normalisation scales in ``norm_names`` 1 + 0.1 n."""
    total = sum(math.prod(s) for _, s in named_shapes)
    flat = torch.randn(total, generator=generator(device, seed, 5, salt), device=device)
    out, views, scales, off = {}, [], [], 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        out[name] = v
        views.append(v)
        if name in norm_names:
            scales.append(0.1)
        elif len(shape) >= 2:
            scales.append(1.0 / math.sqrt(math.prod(shape[1:])))
        else:
            scales.append(0.02)
    torch._foreach_mul_(views, scales)
    norms = [out[n] for n in norm_names if n in out]
    if norms:
        torch._foreach_add_(norms, 1.0)
    return out
