"""What a step needs, counted from shapes on the meta device with the
benchmark's plain reference: the model's floating-point operations (by
``torch.utils.flop_counter``, recomputation not counted, so the count is the
same whatever implements the model) and the attention and GroupNorm calls with
the least operations and bytes each needs (each input read once, each output
written once, in the configuration's compute type). The table of peaks is
``peaks.json``."""

from __future__ import annotations

import json
import math
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import nets

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(device_name: str) -> dict:
    """The peak rates of the card whose name holds a key of ``peaks.json``."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        table = json.load(f)
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no peak rates for {device_name!r} in peaks.json")


def attention_call(B, H, S, D, isz, grad):
    """(flops, bytes) of softmax(q k^T) v over (B, H, S, D), and of its
    backward when ``grad``: forward q k^T and p v; backward dv, dp, dq, dk
    (p not recomputed); q, k, v, o (and do, dq, dk, dv) moved once."""
    fl = B * H * S * S * D
    n = B * H * S * D
    fwd = (4 * fl, 4 * n * isz)
    return [fwd, (8 * fl, 8 * n * isz)] if grad else [fwd]


def groupnorm_call(numel, isz, grad):
    """(flops, bytes) of a GroupNorm(+SiLU): x read, y written; backward x
    and dy read, dx written. Bound by bytes: the operations are not counted."""
    fwd = (0, 2 * numel * isz)
    return [fwd, (0, 3 * numel * isz)] if grad else [fwd]


def bound_s(calls, peak: dict) -> float:
    """Least seconds of ``calls`` [(flops, bytes)] at ``peak``."""
    return sum(max(f / peak["bf16_flops"], b / peak["bytes_per_s"]) for f, b in calls)


def count(fn, models, isz: int) -> dict:
    """Run ``fn()`` (on meta tensors) under the flop counter with hooks on
    the GroupNorms and attention blocks of ``models``: returns {"flops": total,
    "attention": [(flops, bytes)], "groupnorm": [(flops, bytes)]}."""
    calls = {"attention": [], "groupnorm": []}

    def hook(mod, args):
        x = args[0]
        grad = torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in mod.parameters()))
        if isinstance(mod, nets.GroupNorm):
            calls["groupnorm"] += groupnorm_call(x.numel(), isz, grad)
        else:
            B, C, S = x.shape[0], x.shape[1], math.prod(x.shape[2:])
            calls["attention"] += attention_call(B, mod.heads, S, C // mod.heads, isz, grad)

    handles = [m.register_forward_pre_hook(hook) for model in models for m in model.modules()
               if isinstance(m, (nets.GroupNorm, nets.AttentionBlock))]
    try:
        with FlopCounterMode(display=False) as fc:
            fn()
    finally:
        for h in handles:
            h.remove()
    return {"flops": fc.get_total_flops(), **calls}
