"""Rank functions of the port's multi-process tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_ring.py`` on the CPU,
``tests/test_torch_adamw.py``'s sharded norm on the card), and the spawner
that runs them.

``Ranks(fn, world, tmp_dir, *args)`` starts ``world`` processes with the
``spawn`` method and ``join()`` collects their results; each joins a gloo
process group through a ``FileStore`` in ``tmp_dir`` (no TCP port: several
test workers run at once), runs ``fn(rank, world, *args)`` with one torch
thread, and sends its result back. A rank's exception, or no result within
``JOIN_TIMEOUT`` seconds, fails ``join()``; the ranks are then killed. A spawned child imports the module of the
function it runs, so this module imports only torch, numpy and the port:
never JAX.
"""

from __future__ import annotations

import os
import pickle
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT = 120  # seconds a spawned group may take


def _entry(fn, rank, world, store, q, args_path):
    torch.set_num_threads(1)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        q.put((rank, True, pickle.dumps(fn(rank, world, *args))))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """``world`` spawned ranks running ``fn(rank, world, *args)``; ``join()``
    returns [rank 0's result, ...]. The parent may work while they run."""

    def __init__(self, fn, world: int, tmp_dir, *args):
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        store = os.path.join(str(tmp_dir), "store")
        # the arguments go through a file, tensors by value: a start() whose
        # pickle outgrows the pipe waits for its child to start up and read it
        args_path = os.path.join(str(tmp_dir), "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
        self.procs = [ctx.Process(target=_entry, args=(fn, r, world, store, self.q, args_path),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + JOIN_TIMEOUT

    def join(self):
        world, results = len(self.procs), {}
        try:
            while len(results) < world:
                try:
                    rank, ok, value = self.q.get(timeout=1.0)
                except queue.Empty:
                    if time.monotonic() > self.deadline:
                        raise TimeoutError(f"{world} ranks gave {len(results)} results in "
                                           f"{JOIN_TIMEOUT} s")
                    dead = [r for r, p in enumerate(self.procs) if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"ranks {dead} died (exit codes "
                                           f"{[self.procs[r].exitcode for r in dead]})")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results[rank] = pickle.loads(value)
        finally:
            for p in self.procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        return [results[r] for r in range(world)]


def _np(sd):
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()}


def _tensors(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


RING_GATE = "32"  # MEDIMGEN_RING_MIN_SEQ for the DDPM steps: the tiny U-Net's 64-token sites


def _ddpm_step(dd, mesh):
    """One tiny DDPM step on ``mesh`` from the global batch's draws, this
    rank's data rows, with the ring's gate at ``RING_GATE``. Returns (record,
    trainer, checkpoint payload); the record holds the global loss, the
    clipped gradient's norm, the ring's calls, the sharding layout and local
    shapes, and the gathered params and Adam first moments."""
    from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
    from medical_image_generation_tpu_torch.ops import kernels
    from medical_image_generation_tpu_torch.parallel import mesh as pmesh
    from medical_image_generation_tpu_torch.training.train_ddpm import DDPMTrainer

    os.environ["MEDIMGEN_RING_MIN_SEQ"] = RING_GATE
    unet = DiffusionUNet.from_config(dd["unet_params"], dtype=torch.float32)
    unet.load_state_dict(_tensors(dd["unet"]))
    tr = DDPMTrainer(dd["cfg"], unet, device="cpu", mesh=mesh)
    off, cnt = pmesh.data_axis_rows(mesh, dd["x"].shape[0])
    before = kernels.read("ring_attention.calls")
    loss = float(tr.train_step(torch.from_numpy(dd["x"][off:off + cnt]), draws=dd["draws"]))
    calls = kernels.read("ring_attention.calls") - before
    payload = tr.checkpoint_payload(0, loss)
    return dict(loss=loss, norm=float(tr.opt.last_norm), ring_calls=calls,
                layout=dict(tr.layout),
                local_shapes={n: tuple(p.shape) for n, p in tr.unet.named_parameters()},
                params=_np(payload["unet"]),
                mu={n: t.float().numpy() for n, t in payload["opt_state"]["mu"].items()}), \
        tr, payload


# ----------------------------------------------------------------- parallel


def parallel_checks(rank, world, inp, ckpt_dir):
    """Every check of ``tests/test_torch_parallel.py`` on 2 ranks: the
    meshes, a data-parallel LDM step and AE step (adversarial loss on), a
    model-parallel DDPM step (the ring inside its sharded attention) and its
    gradient norm, and a checkpoint that the model-parallel ranks write."""
    from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
    from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
    from medical_image_generation_tpu_torch.models.discriminator import PatchDiscriminator
    from medical_image_generation_tpu_torch.models.perceptual import PerceptualLoss
    from medical_image_generation_tpu_torch.parallel import mesh as pmesh
    from medical_image_generation_tpu_torch.training import common
    from medical_image_generation_tpu_torch.training.common import build_generator
    from medical_image_generation_tpu_torch.training.train_autoencoder import AutoEncoderTrainer
    from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer

    out = {}
    dp = pmesh.get_mesh()
    tp = pmesh.get_mesh(model_parallel=2)
    out["mesh"] = dict(dp_shape=dp.shape, dp_coords=dp.coords, tp_shape=tp.shape,
                       tp_coords=tp.coords, rows=pmesh.data_axis_rows(dp, 4),
                       tp_rows=pmesh.data_axis_rows(tp, 4),
                       put=pmesh.put_batch(np.arange(6.0).reshape(3, 2), dp).numpy())
    errors = []
    for kw in (dict(n_devices=4), dict(model_parallel=3)):
        try:
            pmesh.get_mesh(**kw)
        except ValueError as e:
            errors.append(str(e))
    out["mesh"]["errors"] = errors

    # data-parallel LDM step: this rank's rows, the global batch's draws
    ldm = inp["ldm"]
    unet = DiffusionUNet.from_config(ldm["ddpm_params"], dtype=torch.float32)
    unet.load_state_dict(_tensors(ldm["unet"]))
    vae = AutoencoderKL.from_config(ldm["vae_params"], dtype=torch.float32)
    vae.load_state_dict(_tensors(ldm["vae"]))
    tr = LDMTrainer(ldm["cfg"], unet, vae, device="cpu", mesh=dp)
    tr.scale_factor = ldm["scale"]
    off, cnt = pmesh.data_axis_rows(dp, ldm["x"].shape[0])
    loss = tr.train_step(torch.from_numpy(ldm["x"][off:off + cnt]), draws=ldm["draws"])
    out["ldm"] = dict(loss=float(loss), params=_np(dict(tr.unet.named_parameters())),
                      mu=_np(dict(zip(tr.param_names, tr.opt.mu))))

    # data-parallel AE step with the adversarial loss
    ae = inp["ae"]
    gen = build_generator(ae["cfg"], "vae", torch.float32, device="cpu")
    gen.load_state_dict(_tensors(ae["g"]))
    disc = PatchDiscriminator.from_config(ae["cfg"]["discriminator_params"], dtype=torch.float32,
                                          device="cpu")
    disc.load_state_dict(_tensors(ae["d"]))
    perc = PerceptualLoss.from_config(ae["cfg"]["perceptual_params"], dtype=torch.float32,
                                      device="cpu")
    perc.module.load_state_dict(_tensors(ae["perc"]))
    atr = AutoEncoderTrainer(ae["cfg"], gen, disc, perc, "vae", device="cpu", mesh=dp)
    off, cnt = pmesh.data_axis_rows(dp, ae["x"].shape[0])
    m = atr.train_step(torch.from_numpy(ae["x"][off:off + cnt]), True, draws=ae["draws"])
    out["ae"] = dict(metrics={k: float(v) for k, v in m.items()},
                     g=_np(dict(atr.model.named_parameters())),
                     d=_np(dict(atr.discriminator.named_parameters())),
                     g_mu=_np(dict(zip(atr.g_names, atr.g_opt.mu))),
                     d_mu=_np(dict(zip(atr.d_names, atr.d_opt.mu))))

    # model-parallel DDPM step (data 1, model 2), its clipped gradient's norm;
    # the gate below the 64-token sites puts the ring inside the sharded
    # AttentionBlocks there
    d, dtr, payload = _ddpm_step(inp["ddpm"], tp)
    dtr.save_dict = {"checkpoints": ckpt_dir}
    d["saved"] = common.save_last_best(dtr, 0, d["loss"], lambda: payload)
    out["ddpm"] = d
    return out


# --------------------------------------------------------------------- ring


def ring_checks(rank, world, inp):
    """Every multi-rank check of ``tests/test_torch_ring.py`` on 4 ranks:
    the ring forward and gradients at n = 2 and 4 (fp32), the dispatch gate,
    the ring inside the tiny 2D U-Net against the same U-Net without it, and
    a tiny DDPM step on the data 2 x model 2 mesh."""
    from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
    from medical_image_generation_tpu_torch.ops import attention, kernels, ring_attention
    from medical_image_generation_tpu_torch.ops.flash_attention import flash_attention_plain
    from medical_image_generation_tpu_torch.parallel.comm import AxisGroup
    from medical_image_generation_tpu_torch.parallel.mesh import get_mesh

    out = {}
    q, k, v, w = (torch.from_numpy(inp[n]) for n in "qkvw")
    scale = q.shape[-1] ** -0.5
    meshes = {n: get_mesh(model_parallel=n) for n in (2, 4)}
    for n, mesh in meshes.items():
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = ring_attention.ring_attention_sharded(qs, ks, vs, AxisGroup.of(mesh, "model"), scale)
        (o * w).sum().backward()
        out[n] = dict(o=o.detach().numpy(), dq=qs.grad.numpy(), dk=ks.grad.numpy(),
                      dv=vs.grad.numpy())

    # the gate: ring only for an active mesh with model > 1, S > the gate,
    # S divisible by the model axis and one shape for q, k and v
    os.environ["MEDIMGEN_RING_MIN_SEQ"] = "64"
    g = torch.Generator().manual_seed(5)
    a, b, c = (torch.randn((2, 128, 2, 8), generator=g) for _ in range(3))
    calls = {}

    def counted(label, mesh, *qkv):
        before = kernels.read("ring_attention.calls")
        if mesh is None:
            o = attention.dot_product_attention(*qkv)
        else:
            with mesh:
                o = attention.dot_product_attention(*qkv)
        calls[label] = kernels.read("ring_attention.calls") - before
        return o

    o_ring = counted("engaged", meshes[2], a, b, c)
    out["gate_err"] = float((o_ring - flash_attention_plain(a, b, c, 8 ** -0.5)[0]).abs().max())
    counted("no_mesh", None, a, b, c)
    counted("at_gate", meshes[2], a[:, :64], b[:, :64], c[:, :64])
    counted("model_1", get_mesh(), a, b, c)
    counted("indivisible", meshes[4], a[:, :66], b[:, :66], c[:, :66])
    counted("context", meshes[2], a, b[:, :100], c[:, :100])
    out["calls"] = calls

    # ring gradients inside the tiny 2D U-Net (level 1's 8x8 = 64 tokens)
    un = inp["unet"]
    unet = DiffusionUNet.from_config(un["params"], dtype=torch.float32)
    unet.load_state_dict(_tensors(un["state"]))
    x, t = torch.from_numpy(un["x"]), torch.zeros((2,), dtype=torch.long)

    def grads(gate):
        os.environ["MEDIMGEN_RING_MIN_SEQ"] = str(gate)
        unet.zero_grad(set_to_none=True)
        before = kernels.read("ring_attention.calls")
        with meshes[2]:
            torch.mean(unet(x, t) ** 2).backward()
        return ({n: p.grad.clone() for n, p in unet.named_parameters()},
                kernels.read("ring_attention.calls") - before)

    g_ring, n_ring = grads(32)
    g_ref, n_ref = grads(1 << 30)
    out["unet"] = dict(n_ring=n_ring, n_ref=n_ref, err={
        n: float((g_ring[n] - g_ref[n]).abs().max() / (g_ref[n].abs().max() + 1e-12))
        for n in g_ref})

    # a tiny DDPM step on the data 2 x model 2 mesh: the gradient mean over
    # the data axis around the Megatron collectives and the ring's
    out["ddpm_2x2"] = _ddpm_step(inp["ddpm"], meshes[2])[0]
    return out


def adamw_sharded_step(rank, world, params_by_rank, grads_by_rank, sharded):
    """One clipped AdamW step on the card (the optimizer's kernels) with the
    Megatron layout's norm over a model axis of ``world`` ranks: this rank's
    params and gradients, ``sharded`` the tensors that are this rank's
    shards. Returns (the norm, the params after the step) on the CPU."""
    from medical_image_generation_tpu_torch.parallel.comm import AxisGroup
    from medical_image_generation_tpu_torch.training import common

    dev = torch.device("cuda")
    params = [p.to(dev) for p in params_by_rank[rank]]
    grads = [g.to(dev) for g in grads_by_rank[rank]]
    opt = common.AdamW(params, lambda s: 1e-3, 1.0, 1e-2, mu_dtype=torch.bfloat16,
                       sharded=sharded, norm_axis=AxisGroup(dist.group.WORLD, rank, world))
    opt.step(grads)
    return float(opt.last_norm), [p.cpu() for p in params]
