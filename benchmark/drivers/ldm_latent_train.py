"""Driver of the cells that train a latent diffusion U-Net on precomputed
latents (MAISI's ``diff_model_train``): ``LDMTrainer.train_step`` with
``latent_space_type="precomputed"`` in a closed loop (``loop.run``).

Set-up builds one trainer from the configuration with the benchmark's seeded
weights (no autoencoder), fixes its latent scale with ``probe_latent`` on the
pool's first batch, and takes the first ``checked_steps`` steps through the
window's own call and feed: each latent batch copied through
``common.batch_to_device``, as a loader's batch is, with the step's draws
(timesteps, noise) and its conditioning (the top and bottom body regions as
one-hots, the voxel spacing) given. The readings are those of
``ldm_train``: each step's loss, each leaf's first gradient as AdamW
received it, each leaf's change after the checked steps.

Faults planted under the timed path (``FAULTS``), for the tests and the
calibration of the output check: ``heads_merged`` (each attention block one
head of its whole width), ``cond_dropped`` (the three embeddings zeroed) and
``faults.unchanged``.

Beside ``loop.compare``'s numbers the check reads ``attn_qk_gap``: each
attention block's first gradient over the q and k rows of its fused QKV
weight, where the split into heads and the head_dim^-0.5 scale enter it (a
leaf's whole norm is mostly v's and barely sees them), as a norm against the
reference's, the clip's common factor taken out; the worst block. It is
compared where the cell's ``limits`` give it one.
"""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import faults, loop, rooflines, traffic
from benchmark.reference import ldm as ref_ldm
from benchmark.reference import maisi, nets


def weights(cfg, seed, device):
    """The U-Net's state dict of the seed, fp32 on ``device``."""
    unet = maisi.UNet(cfg["ddpm_params"])
    return traffic.weights(ref_ldm.named_shapes(unet), nets.norm_weights(unet), seed, 0, device)


def batches(work, seed, device) -> list:
    """``work["pool"]`` latent batches (B, *spatial, C) as fp32 host arrays:
    a coarse normal grid upsampled to the latent grid plus fine noise, made
    on ``device`` in one call."""
    lat = work["latent"]
    B, C, shape = work["batch"], lat["channels"], tuple(lat["spatial"])
    n = work["pool"]
    gen = traffic.generator(device, seed, 1)
    coarse = torch.randn((n * B * C, 1, *lat["coarse"]), generator=gen, device=device)
    vol = F.interpolate(coarse, size=shape, mode="trilinear", align_corners=False)
    vol = vol + lat["fine_noise"] * torch.randn(vol.shape, generator=gen, device=device)
    host = vol.reshape(n, B, C, *shape).movedim(2, -1).float().cpu().numpy()
    return [np.ascontiguousarray(host[i]) for i in range(n)]


def draws(work, seed, device) -> list:
    """``work["pool"]`` draws: ``t`` (host int64, uniform over the
    timesteps), ``noise`` (card, (B, *spatial, C)) and ``cond`` (card fp32):
    ``top_region_index`` and ``bottom_region_index`` one-hots over the
    regions, the top at or above the bottom, and ``spacing`` (x, y, z) in mm,
    one in-plane value for x and y."""
    lat, cond = work["latent"], work["cond"]
    B, R = work["batch"], cond["regions"]
    out = []
    for k in range(work["pool"]):
        host = traffic.generator("cpu", seed, 2, k)
        dev = traffic.generator(device, seed, 3, k)
        top = torch.randint(0, R, (B,), generator=host)
        bottom = top + (torch.rand(B, generator=host) * (R - top)).long()
        lo, hi = cond["in_plane_mm"]
        xy = lo + (hi - lo) * torch.rand(B, generator=host)
        lo, hi = cond["slice_mm"]
        z = lo + (hi - lo) * torch.rand(B, generator=host)
        c = dict(top_region_index=F.one_hot(top, R).float(),
                 bottom_region_index=F.one_hot(bottom, R).float(),
                 spacing=torch.stack([xy, xy, z], dim=1))
        out.append(dict(
            t=torch.randint(0, work["timesteps"], (B,), generator=host),
            noise=torch.randn((B, *lat["spatial"], lat["channels"]), generator=dev,
                              device=device),
            cond={name: v.to(device) for name, v in c.items()}))
    return out


def pools(cell):
    return batches(cell.work, cell.seed, cell.device), draws(cell.work, cell.seed, cell.device)


def build(cell, host):
    """The trainer with the seed's weights and its latent probe."""
    from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer

    work, dev = cell.work, cell.device
    unet_w = weights(cell.cfg, cell.seed, dev)
    trainer = LDMTrainer.from_config(cell.cfg, None, unet_w, device=dev,
                                     dtype=getattr(torch, work["compute_dtype"]),
                                     seed=traffic.seed_of(cell.seed) % 2 ** 31,
                                     latent_space_type="precomputed")
    del unet_w
    trainer.probe_latent(torch.as_tensor(host[0]))
    return trainer


def step_fn(trainer, host, draws, rows=None):
    """Step k: latent batch k and draws k of the pools."""
    from medical_image_generation_tpu_torch.training import common

    pd = [(common.TrainDraws(augment=None, eps=None, t=d["t"], noise=d["noise"]),
           {f"{name}_tensor": v for name, v in d["cond"].items()}) for d in draws]

    def step(k):
        imgs, _ = common.batch_to_device(host[k % len(host)], trainer.device)
        d, cond = pd[k % len(pd)]
        return trainer.train_step(imgs, draws=d, cond=cond)
    return step


def readings(trainer, step, cell):
    """The checked steps and the program's readings."""
    losses, grad_sq, grad_norm = [], None, 0.0
    for k in range(cell.work["checked_steps"]):
        losses.append(step(k))
        if k == 0:
            grad_sq = loop.first_grad_sq(trainer.opt, ref_ldm.B2)
            if trainer.opt.last_norm is not None:  # None: no optimizer step ran
                grad_norm = float(trainer.opt.last_norm)
    p0 = weights(cell.cfg, cell.seed, cell.device)
    with torch.no_grad():  # held on the host until the reference says which entries count
        delta = [(p.float() - p0[name]).cpu()
                 for name, p in zip(trainer.param_names, trainer.params)]
    names = list(trainer.param_names)
    return dict(names=names, losses=torch.stack(losses).tolist(), grad_sq=grad_sq,
                grad_norm=grad_norm, delta=delta, qk=qk_norms(names, grad_sq, square=True))


def qk_norms(names, grads, square=False) -> list:
    """Each attention block's norm of the first gradient over the q and k
    rows of ``Dense_0.weight`` (3C, C); of the squared gradient's rows with
    ``square``."""
    out = []
    for name, g in zip(names, grads):
        if name.startswith("AttentionBlock_") and name.endswith(".Dense_0.weight"):
            rows = g[:2 * g.shape[1]].float()
            out.append(float(rows.sum().sqrt() if square else torch.linalg.vector_norm(rows)))
    return out


def reference(cell, host, draws, mode=None):
    ref = maisi.follow(cell.cfg, cell.work, weights(cell.cfg, cell.seed, cell.device), host,
                       draws, cell.device, steps=cell.work["checked_steps"],
                       rows=cell.work["reference_rows"], mode=mode)
    ref["qk"] = [n * ref["grad_scale"] for n in qk_norms(ref["names"], ref["grad0"])]
    return ref


def flop_count(cell):
    """The step's operations and its attention and GroupNorm calls, on meta:
    the U-Net's forward and backward."""
    work, lat = cell.work, cell.work["latent"]
    unet = maisi.UNet(cell.cfg["ddpm_params"])
    B = work["batch"]

    def step():
        z = torch.empty((B, lat["channels"], *lat["spatial"]), device="meta")
        t = torch.zeros((B,), dtype=torch.long, device="meta")
        cond = {f"{name}_tensor": torch.empty((B, n), device="meta")
                for name, n in unet.embeddings}
        ((unet(z, t, **cond) - z) ** 2).mean().backward()

    isz = torch.empty((), dtype=getattr(torch, work["compute_dtype"])).element_size()
    return rooflines.count(step, (unet,), isz)


def heads_merged(driver, trainer, host, draws):
    """Each attention block computes one head of its whole width."""
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock

    for m in trainer.unet.modules():
        if isinstance(m, AttentionBlock):
            m.num_heads, m.head_dim = 1, m.num_heads * m.head_dim
    return driver.step_fn(trainer, host, draws)


def cond_dropped(driver, trainer, host, draws):
    """The region and spacing embeddings zeroed: each MLP's output replaced
    by zeros."""
    unet = trainer.unet
    for name, _ in unet.embeddings:
        getattr(unet, f"{name}_layer").register_forward_hook(lambda m, i, o: torch.zeros_like(o))
    return driver.step_fn(trainer, host, draws)


FAULTS = {"heads_merged": heads_merged, "cond_dropped": cond_dropped,
          "unchanged": faults.unchanged}

DRIVER = SimpleNamespace(pools=pools, build=build, step_fn=step_fn, readings=readings,
                         reference=reference, flop_count=flop_count)


def attn_check(checks, prog, ref, limits):
    """``checks`` with ``attn_qk_gap`` added, from the two sides after
    ``loop.compare``: the clip's common factor is the median over the leaves
    of the program's gradient norm over the reference's, as in
    ``loop.scaled_gaps``."""
    on = [c is not None and r > 0 for c, r in zip(ref["change"], ref["grad"])]
    c = statistics.median(p / r for p, r, k in zip(prog["grad"], ref["grad"], on) if k)
    gaps = [1.0] if c <= 0 else [abs(p / c - r) / r for p, r in zip(prog["qk"], ref["qk"])]
    checks["attn_qk_gap"] = {"value": max(gaps), "limit": limits.get("attn_qk_gap")}
    return checks


def run(cell, fault=None):
    out = loop.run(cell, DRIVER, fault)
    r = out["readings"]
    attn_check(out["checks"], r["program"], r["reference"], cell.work["limits"])
    return out


def follow_control(cell, mode="fp8"):
    checks, low, ref = loop.control(cell, DRIVER, mode)
    return attn_check(checks, low, ref, cell.work["limits"])
