"""Measurement helpers shared by ``chip_smoke.py`` and ``bench/dist_steps.py``:
seeded random weights for every layer, and the table of the port's kernel
wrappers whose ``launches`` counters show which kernels a path ran."""

from __future__ import annotations

import math

import torch


def kernel_counters() -> dict:
    """{kernel name: wrapper}; each wrapper's ``launches`` counts the
    launches of its kernel on the card."""
    from medical_image_generation_tpu_torch.ops import adamw
    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.ops import groupnorm as gn

    return {"flash_attn_fwd": fa.flash_attention, "flash_attn_bwd_dq": fa.flash_bwd_dq,
            "flash_attn_bwd_dkdv": fa.flash_bwd_dkdv, "gn_stats_fold": gn.stats_fold,
            "gn_affine_act": gn.affine_act,
            "gn_bwd_stats": gn.gn_bwd_stats, "gn_bwd_apply": gn.gn_bwd_apply,
            "sq_norm": adamw.sq_norm, "adamw_update": adamw.adamw_update}


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
