"""Driver of the latent diffusion training cells: ``LDMTrainer.train_step``
in a closed loop, as the CLI's epoch loop calls it (``loop.run``).

Set-up builds one trainer from the configuration with the benchmark's seeded
weights, fixes its latent scale with ``probe_latent`` on the pool's first
batch, and takes the first ``checked_steps`` steps through the window's own
call and feed (each batch copied through ``common.batch_to_device``, the
draws given), reading the program's numbers for the output check: each
step's loss, each leaf's first gradient as AdamW received it, and each
leaf's change after the checked steps.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import loop, rooflines, traffic
from benchmark.reference import ldm as ref_ldm
from benchmark.reference import nets


def weights(cfg, seed, device):
    """(U-Net, KL-VAE) state dicts of the seed, fp32 on ``device``."""
    unet, vae = ref_ldm.models(cfg)
    return tuple(traffic.weights(ref_ldm.named_shapes(m), nets.norm_weights(m), seed, salt,
                                 device) for salt, m in enumerate((unet, vae)))


def augment_draws(a, rows):
    """The benchmark's augmentation draws as the program's ``AugmentDraws``
    (the first ``rows`` rows)."""
    from medical_image_generation_tpu_torch.data.augment import AugmentDraws

    B = a["scale"].shape[0]
    d = AugmentDraws(rot_on=a.get("rot_on", torch.zeros(B, dtype=torch.bool)),
                     scale_on=a["scale_on"], angle=a.get("angle", torch.zeros(B)),
                     scale=a["scale"], flips=a["flips"], bright_on=a["bright_on"],
                     bright=a["bright"], contrast_on=a["contrast_on"], contrast=a["contrast"],
                     gamma_on=a["gamma_on"], gamma=a["gamma"])
    return type(d)(*(None if f is None else f[:rows] for f in d))


def pools(cell):
    return (traffic.batches(cell.work, cell.seed, cell.device),
            traffic.draws(cell.work, cell.seed, cell.device))


def build(cell, host):
    """The trainer with the seed's weights and its latent probe."""
    from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer

    work, dev = cell.work, cell.device
    unet_w, vae_w = weights(cell.cfg, cell.seed, dev)
    trainer = LDMTrainer.from_config(cell.cfg, vae_w, unet_w, device=dev,
                                     dtype=getattr(torch, work["compute_dtype"]),
                                     seed=traffic.seed_of(cell.seed) % 2 ** 31)
    del unet_w, vae_w
    trainer.probe_latent(torch.as_tensor(host[0]),
                         generator=traffic.probe_generator(work, cell.seed, dev))
    return trainer


def step_fn(trainer, host, draws, rows=None):
    """Step k: batch k and draws k of the pools (their first ``rows`` rows)."""
    from medical_image_generation_tpu_torch.training import common

    rows = rows or host[0].shape[0]
    pd = [common.TrainDraws(augment=augment_draws(d["augment"], rows), eps=d["eps"][:rows],
                            t=d["t"][:rows], noise=d["noise"][:rows]) for d in draws]

    def step(k):
        imgs, _ = common.batch_to_device(host[k % len(host)][:rows], trainer.device)
        return trainer.train_step(imgs, draws=pd[k % len(pd)])
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
    p0 = weights(cell.cfg, cell.seed, cell.device)[0]
    with torch.no_grad():  # held on the host until the reference says which entries count
        delta = [(p.float() - p0[name]).cpu()
                 for name, p in zip(trainer.param_names, trainer.params)]
    return dict(names=list(trainer.param_names), losses=torch.stack(losses).tolist(),
                grad_sq=grad_sq, grad_norm=grad_norm, delta=delta)


def reference(cell, host, draws, mode=None):
    unet_w, vae_w = weights(cell.cfg, cell.seed, cell.device)
    return ref_ldm.follow(cell.cfg, cell.work, unet_w, vae_w, host, draws,
                          traffic.probe_generator(cell.work, cell.seed, cell.device),
                          cell.device, steps=cell.work["checked_steps"],
                          rows=cell.work["reference_rows"], mode=mode)


def flop_count(cell):
    """The step's operations and its attention and GroupNorm calls, on meta:
    the frozen encoder's forward, the U-Net's forward and backward."""
    work = cell.work
    unet, vae = ref_ldm.models(cell.cfg)
    vae.requires_grad_(False)
    B, lat = work["batch"], work["latent"]

    def step():
        x = torch.empty((B, work["images"]["channels"], *work["augment"]["crop_to"]),
                        device="meta")
        with torch.no_grad():
            vae.encode(x)
        z = torch.empty((B, lat["channels"], *lat["spatial"]), device="meta")
        t = torch.zeros((B,), dtype=torch.long, device="meta")
        ((unet(z, t) - z) ** 2).mean().backward()

    isz = torch.empty((), dtype=getattr(torch, work["compute_dtype"])).element_size()
    return rooflines.count(step, (unet, vae), isz)


DRIVER = SimpleNamespace(pools=pools, build=build, step_fn=step_fn, readings=readings,
                         reference=reference, flop_count=flop_count)


def run(cell, fault=None):
    return loop.run(cell, DRIVER, fault)


def follow_control(cell, mode="fp8"):
    return loop.control(cell, DRIVER, mode)[0]
