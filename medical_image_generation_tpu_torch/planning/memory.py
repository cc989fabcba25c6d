"""Batch-size selection from trial steps of the shipped AE step on the card.

The port's counterpart of ``medical_image_generation_tpu/planning/
memory.py`` (:1-230). The reference picks batch size / grad accumulation by
training one epoch per candidate and catching CUDA out-of-memory errors
(configuration.py:1448-1526, ``auto_select_hyperparams``); the JAX package
replaced the trial with XLA's compile-time memory analysis. The port keeps
the JAX search ladder, line for line, and measures each candidate with a
short trial of the SHIPPED step on the card instead: ``AutoEncoderTrainer``
built from the config, three ``train_step(adv_on=True)`` calls (device
augmentation, L1 + perceptual + KL + LSGAN, the discriminator's update,
both optimizers; the first call creates the optimizer states) on a batch of
the loader's enlarged patch (``compute_initial_patch_size``). The trial's
own peak is the caching allocator's ``max_memory_reserved`` after
``empty_cache`` and ``reset_peak_memory_stats``, less what was reserved
before it; ``torch.cuda.OutOfMemoryError`` means "does not fit", as in the
reference's probe. The budget is ``SAFETY_FRACTION`` of the card's memory.

Ladder: (batch, no remat) -> (batch, remat "acts") -> (batch, remat "full")
-> halve the batch with grad_accum=2 (2D halves toward min 6, 3D halves once
to min 1 — configuration.py:1504-1526). The JAX ladder also handles an
estimate of None (no memory analysis on the backend); a trial on the card
always measures or raises, so that case is not copied. On the CPU the
budget and the estimate raise.
"""

from __future__ import annotations

import copy
import gc
import math
import time
from typing import Dict, NamedTuple, Optional

import torch

from medical_image_generation_tpu_torch._device import resolve_device

SAFETY_FRACTION = 0.92  # leave headroom for the runtime + host transfers
TRIAL_STEPS = 3


class MemoryPlan(NamedTuple):
    batch_size: int
    grad_accum: int
    use_checkpointing: bool
    remat_policy: str = "acts"  # meaningful only when use_checkpointing


def require_card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"memory planning measures trial steps on the card, not on {dev}; "
                         "plan without the probe (--no-memory-probe, probe_memory=False)")
    return dev


def device_memory_budget(device="cuda") -> int:
    """``SAFETY_FRACTION`` of the card's memory, in bytes."""
    dev = require_card(device)
    return int(torch.cuda.get_device_properties(dev).total_memory * SAFETY_FRACTION)


def _release(dev) -> None:
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


def trial_ae_step(config: dict, batch_size: int, use_checkpointing: bool = False,
                  remat_policy: str = "acts", device="cuda") -> Dict[str, float]:
    """``TRIAL_STEPS`` calls of the shipped adversarial AE train step at
    ``batch_size`` on the card (see the module docstring): {"reserved",
    "allocated": the trial's peak bytes above what was held before it,
    "ms": wall ms a step after the first}. Raises
    ``torch.cuda.OutOfMemoryError`` when the step does not fit."""
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.training.train_autoencoder import (
        AutoEncoderTrainer,
    )

    dev = require_card(device)
    cfg = copy.deepcopy(config)
    cfg["vae_params"] = dict(cfg["vae_params"], use_checkpointing=use_checkpointing,
                             remat_policy=remat_policy)
    # a pinned numeric weight keeps the probe off the adapt-at-train-start path
    if isinstance(cfg.get("kl_weight"), str):
        cfg["kl_weight"] = 1e-6
    patch = list(cfg["ae_transformations"]["patch_size"])
    if cfg["vae_params"]["spatial_dims"] == 2 and len(patch) == 3:
        patch = patch[-2:]
    # the loader extracts the (possibly rotation/scale-enlarged) INITIAL
    # patch for training; the probe must price that exact batch shape
    patch = compute_initial_patch_size(cfg["ae_transformations"], patch)

    _release(dev)
    reserved0, allocated0 = torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = batch = None
    try:
        trainer = AutoEncoderTrainer.from_config(
            cfg, cfg.get("latent_space_type", "vae"), device=dev, dtype=torch.bfloat16)
        batch = torch.rand((batch_size, *patch, int(trainer.vae_params["in_channels"])),
                           device=dev)
        for i in range(TRIAL_STEPS):
            if i == 1:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
            trainer.train_step(batch, adv_on=True)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / (TRIAL_STEPS - 1)
        return {"reserved": torch.cuda.max_memory_reserved(dev) - reserved0,
                "allocated": torch.cuda.max_memory_allocated(dev) - allocated0, "ms": ms}
    finally:
        del trainer, batch
        _release(dev)


def estimate_ae_step_memory(config: dict, batch_size: int, use_checkpointing: bool = False,
                            remat_policy: str = "acts", device="cuda") -> float:
    """Peak bytes the caching allocator reserved for a trial of the SHIPPED
    adversarial AE train step at ``batch_size`` (``trial_ae_step``), or
    ``math.inf`` when the trial ran out of memory."""
    tag = f" +remat({remat_policy})" if use_checkpointing else ""
    try:
        t = trial_ae_step(config, batch_size, use_checkpointing, remat_policy, device)
    except torch.cuda.OutOfMemoryError:
        t = None
    if t is None:  # outside the except clause: its traceback held the trial's tensors
        _release(require_card(device))
        print(f"  trial batch {batch_size}{tag}: out of memory")
        return math.inf
    print(f"  trial batch {batch_size}{tag}: peak reserved {t['reserved'] / 2**30:.2f} GiB, "
          f"allocated {t['allocated'] / 2**30:.2f} GiB, {t['ms']:.1f} ms a step")
    return t["reserved"]


def auto_select_hyperparams(
    config: dict,
    model_type: str,
    init_batch_size: int,
    init_grad_accum: int = 1,
    budget_bytes: Optional[int] = None,
    device="cuda",
) -> MemoryPlan:
    """Batch size + grad accumulation + remat that fit this card (reference
    ladder semantics, configuration.py:1448-1526, with two remat rungs
    before the first batch halving — see module docstring)."""
    assert model_type in ("2d", "3d")
    budget = budget_bytes if budget_bytes is not None else device_memory_budget(device)
    min_batch = 6 if model_type == "2d" else 1

    def fits(bs: int, remat: bool, policy: str = "acts") -> bool:
        est = estimate_ae_step_memory(config, bs, use_checkpointing=remat,
                                      remat_policy=policy, device=device)
        tag = f" +remat({policy})" if remat else ""
        print(
            f"  batch {bs}{tag}: measured peak "
            f"{est / 1e9:.2f} GB (budget {budget / 1e9:.2f} GB)"
        )
        return est <= budget

    batch, accum = init_batch_size, init_grad_accum
    if fits(batch, False):
        return MemoryPlan(batch, accum, False)

    # rung 2: rematerialization at the planner's batch size. "acts" first
    # (no conv recompute in the backward), then "full" (minimum memory).
    if fits(batch, True, "acts"):
        return MemoryPlan(batch, accum, True, "acts")
    if fits(batch, True, "full"):
        return MemoryPlan(batch, accum, True, "full")

    # rung 3: shrink the batch (full remat stays on), grad_accum=2 preserves
    # the effective batch as in the reference ladder
    if model_type == "2d":
        accum = 2
        while batch > min_batch:
            batch //= 2
            if batch <= min_batch:
                break
            if fits(batch, True, "full"):
                return MemoryPlan(batch, accum, True, "full")
        batch = max(batch, min_batch)
        if not fits(batch, True, "full"):
            print(
                f"Warning! 2D model may not fit even at batch {batch} "
                f"(grad_accum {accum}, remat on)."
            )
        return MemoryPlan(batch, accum, True, "full")

    batch = max(min_batch, batch // 2)
    accum = 2
    # batch == init_batch_size means the planner already started at the
    # minimum: rung 2 answered "does not fit" and re-probing the same shape
    # would only repeat the trial — warn directly
    if batch == init_batch_size or not fits(batch, True, "full"):
        print(
            f"Warning! 3D model may not fit even at batch {batch} "
            f"(grad_accum {accum}, remat on)."
        )
    return MemoryPlan(batch, accum, True, "full")
