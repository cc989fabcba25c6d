"""Measurement helpers shared by ``chip_smoke.py`` and ``bench/dist_steps.py``:
seeded random weights for every layer. The launches of the port's kernels
are counted in ``ops/kernels.py``."""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def randomize_(model: torch.nn.Module, seed: int) -> None:
    """Seeded random values in every parameter, including zero-initialised
    layers: fan-in scaled normals for weights, 0.02 n for biases, GroupNorm
    and LayerNorm scale 1 + 0.1 n; drawn on the parameters' device."""
    from medical_image_generation_tpu_torch.models.blocks import GroupNorm
    from medical_image_generation_tpu_torch.models.diffusion_unet import LayerNorm

    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, (GroupNorm, LayerNorm))}
    for p in model.parameters():
        n = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
        if id(p) in norms:
            p.copy_(1.0 + 0.1 * n)
        elif p.dim() >= 2:
            p.copy_(n / math.sqrt(p[0].numel()))
        else:
            p.copy_(0.02 * n)
