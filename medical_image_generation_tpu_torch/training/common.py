"""Optimizer, learning-rate schedules and EMA of the port's trainers.

Port of ``medical_image_generation_tpu/training/common.py`` (:26-137) in
optax's semantics, written with ``torch._foreach_*`` ops:

* ``clip_by_global_norm``: ``where(norm < max, g, g / norm * max)``, optax's
  form (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and
  differs);
* ``AdamW``: optax ``adamw`` (``scale_by_adam``, decoupled weight decay,
  ``-lr`` scaling) with the first moment stored in ``mu_dtype`` (bf16 for the
  diffusion trainers). As in ``optax.scale_by_adam``, the update uses the
  fp32 moment and only the stored copy is rounded; the decay ``b1 * mu`` is
  a product in the stored dtype with ``b1`` rounded to it, as optax's type
  promotion does (0.8984375 in bf16). ``torch.optim.AdamW``
  cannot hold a bf16 moment beside fp32 params, hence this class;
* ``make_lr_schedule``: constant, ``LinearLR`` and ``PolynomialLR``, stepped
  per optimizer step with ``total_iters`` counted in epochs, as the JAX
  package does;
* ``ema_update``: an exponential moving average of the params.

Gradient accumulation (``optax.MultiSteps``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def make_lr_schedule(base_lr: float, scheduler: Optional[str], params: Optional[Dict],
                     steps_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate, in fp32 arithmetic like the JAX schedules."""
    params = params or {}
    f32 = np.float32
    if scheduler is None:
        return lambda step: float(f32(base_lr))
    total = max(int(params.get("total_iters", 100) * steps_per_epoch), 1)

    def frac(step):
        return f32(np.clip(f32(step) / f32(total), 0.0, 1.0))

    if scheduler == "LinearLR":
        start, end = params.get("start_factor", 1.0), params.get("end_factor", 0.0)
        return lambda step: float(f32(base_lr) * (f32(start) + f32(end - start) * frac(step)))
    if scheduler == "PolynomialLR":
        power = params.get("power", 1.0)
        return lambda step: float(f32(base_lr) * (f32(1.0) - frac(step)) ** f32(power))
    raise ValueError(f"unknown lr_scheduler {scheduler!r}")


def mu_dtype_from_config(config) -> Optional[torch.dtype]:
    """The ``adam_mu_dtype`` config key ('bfloat16' default | 'float32');
    None means the params' dtype."""
    name = str(config.get("adam_mu_dtype", "bfloat16"))
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "fp32"):
        return None
    raise ValueError(f"unknown adam_mu_dtype {name!r}")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip in place in optax's form; returns the norm before clipping. No
    host synchronisation: the choice is made on the device."""
    norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps,
    weight_decay, mu_dtype))`` over a list of params (or ``adam`` when
    ``weight_decay`` is 0). ``step(grads)`` updates the params in place."""

    def __init__(self, params: Sequence[torch.Tensor], lr_schedule: Callable[[int], float],
                 clip: Optional[float] = 1.0, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, mu_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.lr_schedule = lr_schedule
        self.clip, self.wd, self.b1, self.b2, self.eps = clip, weight_decay, b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # updates applied so far

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        grads = [g.float() for g in grads]
        if self.clip:
            clip_by_global_norm(grads, self.clip)
        lr = self.lr_schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu, summed in fp32. As in optax, b1 * mu is a
        # product in the stored moment's dtype, with b1 itself rounded to it
        # (bf16: 0.8984375).
        b1_mu = float(torch.tensor(b1, dtype=self.mu[0].dtype)) if self.mu else b1
        mu = [m.float() for m in torch._foreach_mul(self.mu, b1_mu)]
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.wd:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, self.wd))
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -lr))
        torch._foreach_copy_(self.mu, mu)  # stored moment: rounded to mu_dtype


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: Sequence[torch.Tensor], decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul([p.to(e.dtype) for e, p in zip(ema, params)],
                                                1.0 - decay))
