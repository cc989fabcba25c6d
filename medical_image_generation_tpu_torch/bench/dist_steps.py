"""Three flagship LDM train steps, or one ring attention, on the card under
torchrun (or in one process).

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m medical_image_generation_tpu_torch.bench.dist_steps [--steps 3] [--batch 2]
    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m medical_image_generation_tpu_torch.bench.dist_steps --ring 1,262144,1,512

LDM steps: the planner's flagship 3D configuration, U-Net and KL-VAE with
seeded random weights in every layer (bf16 compute, fp32 masters), a seeded
global batch of ``--batch`` rows of the enlarged loader patch, of which
each rank takes its ``data_axis_rows``, and ``--steps``
``LDMTrainer.train_step`` calls from the trainer's seeded generators on a
data-parallel mesh of every rank. Under torchrun it joins the process group
first (``maybe_initialize_distributed``: NCCL), even at one process. Rank 0
prints one JSON line: the global losses, the gradient norms the clip saw
(averaged over the data axis) and rank 0's own gradient norms before the
average, every rank's sum and absolute sum of its parameters after the
steps (fp64), the ms of each step, each kernel's launches a step (rank
0's), the mesh and the backend. ``run_ldm`` is the same run as a function,
for a caller's own process.

``--ring B,S,H,D``: q, k, v and a cotangent (bf16, seeded alike on every
rank) through ``ring_attention_sharded`` over a model axis of every rank,
forward and backward, against the whole-sequence flash kernels on each
rank at ``RING_TOL`` / ``RING_BWD_TOL``; prints the errors and the ms of
both, two passes each in turns (whole, ring, ring, whole).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from medical_image_generation_tpu_torch.bench import randomize_
from medical_image_generation_tpu_torch.ops import kernels
from medical_image_generation_tpu_torch.parallel.mesh import (
    get_mesh,
    maybe_initialize_distributed,
    put_batch,
)

SEED = 0


def _device() -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK`` under torchrun, else the
    current one."""
    return maybe_initialize_distributed("cuda") or torch.device("cuda",
                                                                torch.cuda.current_device())


def _timed(dev, fn):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _ranks_gather(value):
    """[value of rank 0, rank 1, ...] (one process: [value])."""
    if not dist.is_initialized():
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def run_ldm(steps: int = 3, batch: int = 2) -> dict:
    """The LDM steps of this module's notes on this process's mesh; returns
    the record rank 0 prints."""
    from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
    from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
    from medical_image_generation_tpu_torch.planning.planner import (
        create_config_dict,
        flagship_configs,
        flagship_dataset,
    )
    from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer

    dev = _device()
    vae_p, ddpm_p, _ = flagship_configs(tiny=False)
    cfg = create_config_dict(flagship_dataset(False, 3), [0], 1, vae_p, ddpm_p)
    unet = DiffusionUNet.from_config(ddpm_p, dtype=torch.bfloat16, param_dtype=torch.float32,
                                     device=dev)
    vae = AutoencoderKL.from_config(vae_p, dtype=torch.bfloat16, device=dev)
    randomize_(unet, SEED + 11)
    randomize_(vae, SEED + 12)
    mesh = get_mesh(device=dev)
    tr = LDMTrainer(cfg, unet, vae, device=dev, seed=SEED, mesh=mesh)
    tr.scale_factor = 0.5
    initial = tuple(compute_initial_patch_size(cfg["ddpm_transformations"]))
    x = np.random.default_rng(SEED + 13).uniform(0, 1, (batch, *initial, 1)).astype(np.float32)
    local = put_batch(x, mesh)
    # this rank's gradient norm before the mean over the data axis: what a
    # step that skipped the mean would clip
    local_norms = []
    average = tr.data_axis.all_reduce_mean_

    def recorded_mean_(grads):
        local_norms.append(float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))))
        average(grads)

    tr.data_axis.all_reduce_mean_ = recorded_mean_
    kernels.reset()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        loss, t = _timed(dev, lambda: float(tr.train_step(local)))
        losses.append(loss)
        ms.append(t)
        norms.append(float(tr.opt.last_norm))
    launches = {k: n / steps for k, n in kernels.launches().items()}
    sums = [float(sum(p.detach().double().sum() for p in tr.params)),
            float(sum(p.detach().double().abs().sum() for p in tr.params))]
    rank_sums = _ranks_gather(sums)
    return {"mode": "ldm", "world": dist.get_world_size() if dist.is_initialized() else 1,
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "mesh": mesh.shape, "batch": batch, "patch": list(initial), "losses": losses,
            "norms": norms, "local_norms": local_norms, "checksum": sums[0],
            "abs_checksum": sums[1], "rank_checksums": rank_sums, "ms": ms,
            "launches": launches, "params": sum(p.numel() for p in tr.params),
            "device": torch.cuda.get_device_name(dev)}


def run_ring(shape) -> dict:
    """``--ring``: the ring over every rank against the whole-sequence
    kernels; returns rank 0's record."""
    from medical_image_generation_tpu_torch.ops import flash_attention as fa
    from medical_image_generation_tpu_torch.ops import ring_attention as ra
    from medical_image_generation_tpu_torch.parallel.comm import AxisGroup

    dev = _device()
    world = dist.get_world_size() if dist.is_initialized() else 1
    axis = AxisGroup.of(get_mesh(model_parallel=world, device=dev), "model")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dt) for _ in range(4))
    scale = shape[-1] ** -0.5

    def ring():
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        o, fwd_ms = _timed(dev, lambda: ra.ring_attention_sharded(qs, ks, vs, axis, scale))
        _, bwd_ms = _timed(dev, lambda: o.backward(do))
        return (o.detach(), qs.grad, ks.grad, vs.grad), fwd_ms, bwd_ms

    def whole():
        (o, lse), fwd_ms = _timed(dev, lambda: fa.flash_attention(q, k, v, scale))
        grads, bwd_ms = _timed(dev, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale))
        return (o, *grads), fwd_ms, bwd_ms

    # in turns, whole / ring / ring / whole: the first ring pass also sets
    # up NCCL's point-to-point connections
    runs = {"whole": [], "ring": []}
    for name in ("whole", "ring", "ring", "whole"):
        out, fwd_ms, bwd_ms = (whole if name == "whole" else ring)()
        runs[name].append((fwd_ms, bwd_ms))
        if name == "whole":
            ref = out
        else:
            got = out

    def ratio(got, want, rt, at, rel_max):
        got, want = got.float(), want.float()
        allowed = rt * want.abs() + at * (want.abs().max() if rel_max else 1.0)
        return float(((got - want).abs() / allowed).max())

    ratios = {"o": ratio(got[0], ref[0], *ra.RING_TOL[dt], False)}
    for i, name in enumerate(("dq", "dk", "dv"), 1):
        ratios[name] = ratio(got[i], ref[i], *ra.RING_BWD_TOL[dt], True)
    return {"mode": "ring", "world": world, "shape": list(shape), "dtype": "bfloat16",
            "err_over_allowed": ratios, "ok": all(r <= 1.0 for r in ratios.values()),
            **{f"{name}_{part}_ms": [t[i] for t in runs[name]]
               for name in ("ring", "whole") for i, part in enumerate(("fwd", "bwd"))},
            "device": torch.cuda.get_device_name(dev)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=2, help="global batch")
    p.add_argument("--ring", default=None, metavar="B,S,H,D")
    args = p.parse_args(argv)
    if args.ring:
        rec = run_ring(tuple(int(s) for s in args.ring.split(",")))
    else:
        rec = run_ldm(args.steps, args.batch)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(rec), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if rec.get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
