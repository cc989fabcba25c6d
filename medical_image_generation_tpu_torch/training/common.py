"""Optimizer, learning-rate schedules and EMA of the port's trainers.

Port of ``medical_image_generation_tpu/training/common.py`` (:26-137) in
optax's semantics:

* ``clip_by_global_norm`` (from ``ops/adamw.py``): ``where(norm < max, g,
  g / norm * max)``, optax's form (``torch.nn.utils.clip_grad_norm_`` adds
  1e-6 to the norm and differs);
* ``AdamW``: optax ``adamw`` (``scale_by_adam``, decoupled weight decay,
  ``-lr`` scaling) with the first moment stored in ``mu_dtype`` (bf16 for the
  diffusion trainers). As in ``optax.scale_by_adam``, the update uses the
  fp32 moment and only the stored copy is rounded; the decay ``b1 * mu`` is
  a product in the stored dtype with ``b1`` rounded to it, as optax's type
  promotion does (0.8984375 in bf16). ``torch.optim.AdamW``
  cannot hold a bf16 moment beside fp32 params, hence this class. The clip
  and the update are two kernel passes on CUDA and ``torch._foreach_*`` ops
  on the CPU (``ops/adamw.py``);
* ``make_lr_schedule``: constant, ``LinearLR`` and ``PolynomialLR``, stepped
  per optimizer step with ``total_iters`` counted in epochs, as the JAX
  package does;
* ``MultiSteps``: gradient accumulation as ``optax.MultiSteps`` (0.2.6):
  the running mean ``acc + (g - acc) / (mini_step + 1)`` in fp32, the inner
  clip + AdamW (and with it AdamW's ``count`` and the lr schedule) run only
  on every k-th microstep, on the mean, and the accumulator then returns to
  zero (JAX ``training/common.py:112-123``);
* ``ema_update``: an exponential moving average of the params, which the
  trainer applies only on synced steps (JAX ``:34-52``);
* ``generator_params`` / ``build_generator``: the stage-1 autoencoder of a
  run config (KL-VAE, or VQ-VAE for the ``vq`` latent space), which both
  trainers build;
* ``init_like_flax_``: flax's default initialisation, for training from
  scratch;
* ``l1_loss`` and ``kl_loss``: the autoencoder's reconstruction and KL terms
  (JAX ``:140-153``);
* ``save_last_best``: the last / best checkpoint cadence (JAX ``:178-211``);
* ``batch_to_device`` / ``timed_batches``: a loader batch on the device,
  and the epoch loop's batches with the host seconds of waiting and copying;
* ``TrainDraws`` and ``DiffusionTrainer``: what the two diffusion trainers
  share (the LDM's ``training/train_ldm.py`` and the pixel-space DDPM's
  ``training/train_ddpm.py``): the optimizer and EMA, the step around the
  U-Net, the sampling weights, the last / best payload and its resume, the
  epoch loop, and the training CLIs' common arguments;
* the (data, model) mesh (``parallel/mesh.py``; the JAX trainers' ``mesh``,
  sized by ``config["model_parallel"]``). Every trainer takes one (default
  ``get_mesh(model_parallel=config.get("model_parallel", 1))``) and makes
  it active around its steps and its loop (``with mesh:``, which opens the
  ring-attention gate). Under it: the networks' blocks take the Megatron
  layout over the model axis (``parallel/sharding.py``); a step draws the
  GLOBAL batch's random numbers from the shared generators and takes this
  rank's rows (``local_rows``), so it equals the one-process step at the
  global batch, as JAX's does; the gradients are averaged over the data
  axis (``AxisGroup.all_reduce_mean_``) before ``clip_by_global_norm``,
  whose norm adds the sharded leaves' squares over the model axis and
  counts replicated leaves once; the losses a step returns are the global
  batch's (averaged over the data axis), so every rank logs the same
  numbers and takes the same checkpoint decision; rank 0 writes the
  checkpoints (whole tensors, gathered over the model axis, so a run of any
  layout loads them), the plots and the samples; the data row 0 draws the
  interval samples. The explicit all-reduce was chosen over
  ``DistributedDataParallel``: the optimizer, the clip and the EMA are the
  port's own (optax's semantics), MultiSteps accumulates before any
  reduction, and the model-parallel norm needs the averaged gradients
  before the clip, which DDP's bucketed hooks do not expose more simply.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from medical_image_generation_tpu_torch._device import resolve_device
from medical_image_generation_tpu_torch.config.run import create_save_path_dict
from medical_image_generation_tpu_torch.data.augment import (
    AugmentConfig,
    AugmentDraws,
    augment_batch,
    make_draws,
)
from medical_image_generation_tpu_torch.data.loader import unpack_batch
from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.vqvae import VQVAE
from medical_image_generation_tpu_torch.ops import adamw as adamw_ops
from medical_image_generation_tpu_torch.ops.adamw import clip_by_global_norm
from medical_image_generation_tpu_torch.parallel.comm import AxisGroup
from medical_image_generation_tpu_torch.parallel.mesh import Mesh, data_axis_rows, get_mesh
from medical_image_generation_tpu_torch.parallel.sharding import (
    full_state_dict,
    gather_full,
    local_shards,
    local_state_dict,
    shard_module_,
)
from medical_image_generation_tpu_torch.training import checkpoints as ckpt
from medical_image_generation_tpu_torch.training import plots
from medical_image_generation_tpu_torch.utils.profiling import (
    count,
    host_syncs,
    maybe_progress,
    profile_trace,
    span,
)


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


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps,
    weight_decay, mu_dtype))`` over a list of params (or ``adam`` when
    ``weight_decay`` is 0). ``step(grads)`` updates the params in place.
    ``sharded`` / ``norm_axis``: the Megatron layout's shards and model axis,
    for the clip's norm (``ops.adamw.global_norm``).

    CUDA params take the two kernel passes of ``ops/adamw.py`` (``sq_norm``,
    then ``adamw_update``; between them the all-reduce of the sharded sum
    over ``norm_axis``), which leave the gradients as they were; CPU params
    take the plain ``_foreach`` version, which clips them in place."""

    def __init__(self, params: Sequence[torch.Tensor], lr_schedule: Callable[[int], float],
                 clip: Optional[float] = 1.0, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, mu_dtype: Optional[torch.dtype] = None,
                 sharded: Optional[Sequence[bool]] = None,
                 norm_axis: Optional[AxisGroup] = None):
        self.params = list(params)
        self.sharded, self.norm_axis = sharded, norm_axis
        self.last_norm = None  # the last step's gradient norm before the clip (device)
        self.lr_schedule = lr_schedule
        self.clip, self.wd, self.b1, self.b2, self.eps = clip, weight_decay, b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # updates applied so far
        self._plan = None  # the kernels' tables (ops.adamw.Plan), made at the first CUDA step

    def _hyper(self) -> adamw_ops.Hyper:
        """This step's scalars; counts the step."""
        lr = self.lr_schedule(self.count)
        self.count += 1
        # As in optax, b1 * mu is a product in the stored moment's dtype, with
        # b1 itself rounded to it (bf16: 0.8984375).
        b1_mu = float(torch.tensor(self.b1, dtype=self.mu[0].dtype)) if self.mu else self.b1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.count))
        return adamw_ops.Hyper(lr, self.b1, self.b2, self.eps, self.wd, b1_mu, bc1, bc2)

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]) -> bool:
        """A None gradient (a param the loss did not reach, such as the
        class embedding of a step without labels) counts as zeros, as
        ``jax.grad`` gives optax: the param is still decayed. Returns True
        (every step updates the params)."""
        if self.params and self.params[0].is_cuda:
            return self._step_kernels(grads)
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                 for g, p in zip(grads, self.params)]
        if self.clip:
            self.last_norm = clip_by_global_norm(grads, self.clip, self.sharded, self.norm_axis)
        adamw_ops.adamw_plain_(self.params, grads, self.mu, self.nu, self._hyper())
        return True

    def _step_kernels(self, grads: List[Optional[torch.Tensor]]) -> bool:
        """Three launches: ``sq_norm``'s scratch zeroed, ``sq_norm``,
        ``adamw_update`` (each kernel once more a further
        ``ops.adamw.MAX_TENSORS`` tensors). The plan is made again when a
        param was given other storage."""
        plan = self._plan
        if plan is None or plan.param_ptrs != [p.data_ptr() for p in self.params]:
            plan = self._plan = adamw_ops.Plan(self.params, self.mu, self.nu, self.sharded)
        copies = plan.set_grads(grads)  # gradients copied into their param's layout
        sums = None
        if self.clip:
            sums = adamw_ops.sq_norm(plan)
            if (self.norm_axis is not None and not self.norm_axis.trivial and self.sharded
                    and any(self.sharded)):
                self.norm_axis.sum_(sums[:1])
        norm = adamw_ops.adamw_update(plan, self._hyper(), sums, self.clip)
        del copies  # enqueued: the stream orders any reuse of their memory after the kernels
        if self.clip:
            self.last_norm = norm
        count("adamw_kernel_steps")
        return True

    def state(self) -> Dict[str, Any]:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        torch._foreach_copy_(self.mu, [t.to(m.device) for t, m in zip(state["mu"], self.mu)])
        torch._foreach_copy_(self.nu, [t.to(m.device) for t, m in zip(state["nu"], self.nu)])
        self.count = int(state["count"])


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` over an ``AdamW``.

    ``step(grads)`` folds the microstep's gradients into the fp32 running
    mean (Welford's form, as optax's ``_acc_update`` with ``use_grad_mean``:
    ``acc + (g - acc) / (mini_step + 1)``); on the k-th microstep the inner
    optimizer steps on the mean, the accumulator returns to zero and True is
    returned (a synced step). Other microsteps leave the params alone and
    return False. ``mu``, ``nu`` and ``count`` are the inner AdamW's."""

    def __init__(self, inner: AdamW, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in inner.params]
        self.mini_step = 0

    @property
    def mu(self):
        return self.inner.mu

    @property
    def nu(self):
        return self.inner.nu

    @property
    def count(self) -> int:
        return self.inner.count

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]) -> bool:
        grads = [torch.zeros_like(a) if g is None else g.float()
                 for g, a in zip(grads, self.acc)]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step + 1 < self.every_k:
            self.mini_step += 1
            return False
        self.inner.step(self.acc)  # clip + AdamW on the mean (the CPU's clips it in place)
        torch._foreach_zero_(self.acc)
        self.mini_step = 0
        return True

    def state(self) -> Dict[str, Any]:
        return {**self.inner.state(), "acc": self.acc, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        self.inner.load_state(state)
        torch._foreach_copy_(self.acc, [t.to(a.device) for t, a in zip(state["acc"], self.acc)])
        self.mini_step = int(state["mini_step"])


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: Sequence[torch.Tensor], decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul([p.to(e.dtype) for e, p in zip(ema, params)],
                                                1.0 - decay))


def generator_params(config: dict, latent_space_type: str) -> dict:
    """The generator's architecture dict: ``vae_params``, or for ``vq``
    ``vqvae_params`` when given, else the VAE geometry."""
    if latent_space_type == "vae":
        return config["vae_params"]
    if latent_space_type == "vq":
        return config.get("vqvae_params") or config["vae_params"]
    raise ValueError("latent_space_type must be 'vae' or 'vq'")


def build_generator(config: dict, latent_space_type: str, dtype=torch.bfloat16,
                    param_dtype=None, device=None, with_encoder: bool = True):
    """The KL-VAE or the VQ-VAE of a run config."""
    params = generator_params(config, latent_space_type)
    cls = AutoencoderKL if latent_space_type == "vae" else VQVAE
    return cls.from_config(params, dtype=dtype, param_dtype=param_dtype, device=device,
                           with_encoder=with_encoder)


def init_like_flax_(module: torch.nn.Module) -> None:
    """flax's default initialisation, for training from scratch: conv /
    linear weights lecun_normal (truncated normal, std sqrt(1 / fan_in)),
    biases 0, embeddings normal with std sqrt(1 / features), GroupNorm 1 / 0.
    The U-Net's zero-initialised output conv stays zero."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear)):
                if m.weight.abs().sum() == 0:  # zero-initialised on purpose
                    continue
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.Embedding):
                torch.nn.init.normal_(m.weight, 0.0, math.sqrt(1.0 / m.weight.shape[1]))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def kl_loss(mu, sigma):
    """KL(q || N(0, 1)) summed over the latent dims, averaged over the batch,
    in fp32."""
    var = sigma.float() ** 2
    mu = mu.float()
    per_sample = 0.5 * torch.sum(mu ** 2 + var - torch.log(var + 1e-12) - 1.0,
                                 dim=tuple(range(1, mu.dim())))
    return torch.mean(per_sample)


def save_last_best(trainer, epoch: int, val_loss: float,
                   payload_fn: Callable[[], Dict[str, Any]]) -> List[str]:
    """last/best checkpoint cadence (JAX ``training/common.py:178-211``).

    best_model saves on every val improvement; last_model saves every
    ``checkpoint_interval`` epochs and on the final epoch (default 1 =
    reference parity, train_autoencoder.py:533-560). ``payload_fn`` (the
    device -> host copy of every state) is only called when a save will
    happen. ``best_checkpoint_interval: k`` (default 1) restricts
    best-model candidacy to every k-th epoch and the final epoch;
    ``trainer.best_val`` only advances when a best save happens, so a later
    candidate competes against the last SAVED best. Returns the names
    written.

    In a run of several ranks every rank takes the same decision (the val
    loss is the global batch's); the model row of data coordinate 0 builds
    the payload (gathering the model axis's shards) and rank 0 writes it."""
    improved = val_loss < trainer.best_val
    interval = max(1, int(trainer.config.get("checkpoint_interval", 1)))
    best_interval = max(1, int(trainer.config.get("best_checkpoint_interval", 1)))
    last_epoch = epoch + 1 >= trainer.n_epochs
    want_last = (epoch + 1) % interval == 0 or last_epoch
    want_best = improved and ((epoch + 1) % best_interval == 0 or last_epoch)
    if not (want_best or want_last):
        return []
    mesh = getattr(trainer, "mesh", None)  # None: one process
    writer = mesh is None or mesh.is_writer
    payload = payload_fn() if mesh is None or mesh.coords[0] == 0 else None
    if want_last and writer:
        ckpt.save_checkpoint(trainer.save_dict["checkpoints"], "last_model", payload)
    if want_best:
        trainer.best_val = val_loss
        if writer:
            ckpt.save_checkpoint(trainer.save_dict["checkpoints"], "best_model", payload)
    return ["last_model"] * want_last + ["best_model"] * want_best


def batch_to_device(batch, device: torch.device):
    """A loader batch (array or {"image", "class"}) -> (images, labels or
    None) on ``device``, each copied once: through a pinned buffer without
    blocking the host on the card, or directly on the CPU."""
    with span("medimgen.batch_to_device"):
        imgs, labels = unpack_batch(batch)
        imgs = torch.as_tensor(imgs)
        if device.type == "cuda":
            imgs = imgs.pin_memory().to(device, non_blocking=True)
        if labels is not None:
            labels = torch.as_tensor(np.asarray(labels, np.int64)).to(device)
        return imgs, labels


def timed_batches(loader, device: torch.device, stats: Dict[str, float],
                  show_bar: bool = False, desc: Optional[str] = None):
    """Yield ``loader``'s batches through ``batch_to_device``, adding the
    host seconds spent waiting on the loader to ``stats["wait_s"]`` and
    those of the copy to ``stats["copy_s"]``."""
    it = iter(maybe_progress(loader, show_bar, total=len(loader), desc=desc))
    while True:
        t_wait = time.perf_counter()
        batch = next(it, None)
        t_copy = time.perf_counter()
        if batch is None:
            return
        out = batch_to_device(batch, device)
        stats["wait_s"] += t_copy - t_wait
        stats["copy_s"] += time.perf_counter() - t_copy
        yield out


def local_rows(draws, mesh: Mesh):
    """This rank's rows of a step's random draws, drawn for the GLOBAL batch
    (a NamedTuple of tensors batched on dim 0, nested NamedTuples and
    Nones): rows ``data_axis_rows(mesh, B)`` of each tensor."""
    if mesh.shape["data"] == 1 or draws is None:
        return draws
    if isinstance(draws, tuple):
        return type(draws)(*(local_rows(f, mesh) for f in draws))
    off, cnt = data_axis_rows(mesh, draws.shape[0])
    return draws[off:off + cnt]


def save_dirs(config: dict, mesh: Mesh):
    """``create_save_path_dict``'s (dirs, run path): rank 0 makes the run
    directory and writes its config snapshot; the other ranks get the same
    paths and write nothing."""
    if mesh.is_writer:
        return create_save_path_dict(config)
    path = config["results_path"]
    return ({"checkpoints": os.path.join(path, "checkpoints"),
             "plots": os.path.join(path, "plots")}, path)


def resolve_mesh(mesh: Optional[Mesh], config: dict, device: torch.device) -> Mesh:
    """``mesh``, else ``get_mesh(model_parallel=config["model_parallel"])``
    (default 1) on ``device``: the JAX trainers' default."""
    if mesh is not None:
        return mesh
    return get_mesh(model_parallel=int(config.get("model_parallel", 1)), device=device)


class TrainDraws(NamedTuple):
    """Every random number of one diffusion train step. ``eps``: the KL-VAE
    posterior's noise (None for the VQ latent and the pixel-space DDPM);
    ``drop``: per-sample bool label-dropout coins, or None without class
    conditioning."""

    augment: AugmentDraws
    eps: Optional[torch.Tensor]
    t: torch.Tensor      # (B,) int64 timesteps
    noise: torch.Tensor  # diffusion noise, shaped like what the U-Net sees
    drop: Optional[torch.Tensor] = None


DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class DiffusionTrainer:
    """The body the LDM and the pixel-space DDPM trainers share (JAX
    ``train_ldm.py`` / ``train_ddpm.py``: the same step, loop, payload and
    resume around a U-Net). A subclass says what the U-Net sees:

    * ``noise_shape(batch)``: the shape of the diffusion noise of a batch;
    * ``_clean(imgs, draws)``: the clean target of a (cropped, augmented)
      batch, fp32, under ``no_grad`` (the LDM's scaled latent, the DDPM's
      images);
    * ``sample_images(n, sampler=..., generator=...)``: images in [0, 1];
    * optionally ``_prepare(train_loader)`` before the epochs (the LDM's
      latent probe), ``_host_state`` / ``load_payload`` for more state,
      ``_after_samples(val_loader, stats)`` after the interval samples.

    ``posterior_eps`` says whether a step draws posterior noise, and
    ``samples_3d`` how many volumes the interval samples take in 3D (16
    images in 2D)."""

    posterior_eps = False
    samples_3d = 1

    def __init__(self, config: dict, unet: torch.nn.Module, spatial_dims: int,
                 device: str | torch.device = "cuda", seed: int = 0,
                 steps_per_epoch: int = 250, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.config = config
        self.seed = seed
        self.mesh = resolve_mesh(mesh, config, self.device)
        self.data_axis = AxisGroup.of(self.mesh, "data")
        self.layout = shard_module_(unet, self.mesh)  # {} unless the model axis > 1
        self.unet = unet.train()
        self.spatial_dims = spatial_dims
        self.schedule = NoiseSchedule.from_config(config["time_scheduler_params"],
                                                  device=self.device)
        self.class_cond = config.get("class_conditioning") or None
        if self.class_cond:
            self.num_classes = int(self.class_cond["num_classes"])
            self.cfg_dropout = float(self.class_cond.get("dropout_prob", 0.1))
        self.ema_decay = config.get("ema_decay")
        self.clip = float(config.get("grad_clip_max_norm", 1.0))
        self.aug_cfg = AugmentConfig.from_transformations(
            config.get("ddpm_transformations", {}), spatial_dims=spatial_dims)
        self.params = [p for p in self.unet.parameters() if p.requires_grad]
        self.param_names = [n for n, p in self.unet.named_parameters() if p.requires_grad]
        self.shard_dims = [self.layout.get(n) for n in self.param_names]
        self.grad_accum = int(config.get("grad_accumulate_step", 1))
        self.opt = AdamW(
            self.params,
            make_lr_schedule(float(config.get("ddpm_learning_rate", 2e-5)),
                             config.get("lr_scheduler"), config.get("lr_scheduler_params"),
                             steps_per_epoch),
            clip=self.clip, weight_decay=1e-2, mu_dtype=mu_dtype_from_config(config),
            sharded=[d is not None for d in self.shard_dims],
            norm_axis=AxisGroup.of(self.mesh, "model"))
        if self.grad_accum > 1:
            self.opt = MultiSteps(self.opt, self.grad_accum)
        self.ema = ([p.detach().clone() for p in self.params] if self.ema_decay else None)
        self.host_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.step = 0  # microsteps taken (the JAX TrainState.step)
        # the epoch loop's state
        self.n_epochs = int(config.get("n_epochs", 100))
        self.loss_dict: Dict[str, list] = {"rec_loss": [], "val_rec_loss": []}
        self.start_epoch = 0
        self.best_val = float("inf")
        self.save_dict: Optional[Dict[str, str]] = None
        self.save_path: Optional[str] = None
        self.train_loader = None  # set by train(); its state goes into last/best
        self.epoch_stats: list = []  # one dict of host-side seconds an epoch

    # ------------------------------------------------------------------ steps

    def _final_spatial(self, batch):
        crop = self.aug_cfg.crop_to
        return tuple(crop) if crop is not None else tuple(batch.shape[1:-1])

    def noise_shape(self, batch):
        raise NotImplementedError

    def _clean(self, imgs, draws: TrainDraws):
        raise NotImplementedError

    def make_draws(self, batch, labels=None, generator: Optional[torch.Generator] = None,
                   host_generator: Optional[torch.Generator] = None) -> TrainDraws:
        """The draws of the GLOBAL batch: ``batch`` is this rank's rows, and
        the mesh's data axis times its size is the global batch."""
        B = batch.shape[0] * self.mesh.shape["data"]
        shape = (B, *self.noise_shape(batch)[1:])
        gen = generator or self.generator
        host = host_generator or self.host_generator
        return TrainDraws(
            augment=make_draws(self.aug_cfg, B, batch.shape[-1], batch.dim() - 2, host, gen,
                               tuple(batch.shape[1:-1])),
            eps=(torch.randn(shape, device=self.device, generator=gen)
                 if self.posterior_eps else None),
            t=torch.randint(0, self.schedule.num_train_timesteps, (B,), generator=host),
            noise=torch.randn(shape, device=self.device, generator=gen),
            drop=(torch.rand((B,), generator=host) < self.cfg_dropout
                  if labels is not None and self.class_cond else None))

    def _noised(self, imgs, draws: TrainDraws):
        with torch.no_grad():
            z = self._clean(imgs, draws)
        t = draws.t.to(self.device)
        noise = draws.noise.to(self.device)
        return (self.schedule.add_noise(z, noise, t),
                self.schedule.training_target(z, noise, t), t)

    def train_step(self, batch, labels=None, generator: Optional[torch.Generator] = None,
                   draws: Optional[TrainDraws] = None) -> torch.Tensor:
        """One optimizer step on this rank's rows (B, *spatial_in, C) of the
        global batch, in [0, 1]; ``draws`` are the global batch's. Returns
        the global batch's loss (fp32 device scalar)."""
        with self.mesh:
            return self._train_step(batch, labels, generator, draws)

    def _train_step(self, batch, labels, generator, draws):
        with span("medimgen.train_step"), host_syncs():
            batch = batch.to(self.device)
            if draws is None:
                draws = self.make_draws(batch, labels, generator)
            draws = local_rows(draws, self.mesh)
            with span("medimgen.augment"):
                imgs = augment_batch(batch, draws.augment, self.aug_cfg)
            with span("medimgen.latent"):
                noisy, target, t = self._noised(imgs, draws)
            labels_in = None
            if labels is not None and self.class_cond:
                labels_in = labels.to(self.device)
                if draws.drop is not None:
                    labels_in = torch.where(draws.drop.to(self.device),
                                            torch.full_like(labels_in, self.num_classes),
                                            labels_in)
            for p in self.params:
                p.grad = None
            with span("medimgen.unet_forward"):
                pred = self.unet(noisy, t, class_labels=labels_in)
                loss = torch.mean((pred.float() - target) ** 2)
            with span("medimgen.unet_backward"):
                loss.backward()
            with span("medimgen.optimizer"):
                grads = [p.grad for p in self.params]
                self.data_axis.all_reduce_mean_([g for g in grads if g is not None])
                synced = self.opt.step(grads)
                if self.ema is not None and synced:
                    ema_update(self.ema, self.params, float(self.ema_decay))
            self.step += 1
            return self.data_axis.mean(loss.detach())

    @torch.no_grad()
    def val_step(self, batch, labels=None, generator: Optional[torch.Generator] = None,
                 draws: Optional[TrainDraws] = None,
                 host_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The global batch's loss on this rank's rows of a final-size batch:
        no augmentation, no label dropout."""
        batch = batch.to(self.device)
        if draws is None:
            draws = self.make_draws(batch, None, generator, host_generator)
        draws = local_rows(draws, self.mesh)
        noisy, target, t = self._noised(batch, draws)
        lab = labels.to(self.device) if labels is not None and self.class_cond else None
        with self.mesh:
            pred = self.unet(noisy, t, class_labels=lab)
        return self.data_axis.mean(torch.mean((pred.float() - target) ** 2))

    # ---------------------------------------------------------------- sampling

    @contextlib.contextmanager
    def sampling_weights(self):
        """The U-Net in eval mode with the EMA weights swapped in when EMA
        is on (the JAX ``_sampling_params``); the live params and train mode
        come back on exit. The swap moves tensor handles, not data."""
        swap = self.ema is not None
        if swap:
            for i, p in enumerate(self.params):
                p.data, self.ema[i] = self.ema[i], p.data
        self.unet.eval()
        try:
            yield self.unet
        finally:
            self.unet.train()
            if swap:
                for i, p in enumerate(self.params):
                    p.data, self.ema[i] = self.ema[i], p.data

    def sample_images(self, n_samples: int, sampler: str = "ddim",
                      num_inference_steps: Optional[int] = None,
                      generator: Optional[torch.Generator] = None) -> np.ndarray:
        raise NotImplementedError

    # ------------------------------------------------------------ checkpoint

    def _host_state(self) -> Dict[str, Any]:
        """The sampler's part of a payload: ``unet`` (the live params) and
        ``ema_unet`` when EMA is on, every tensor whole (gathered over the
        model axis) and copied to the CPU."""
        out = {"unet": full_state_dict(self.unet, self.layout, self.mesh)}
        if self.ema is not None:
            out["ema_unet"] = {n: e.cpu() for n, e in zip(
                self.param_names, gather_full(self.ema, self.shard_dims, self.mesh))}
        return out

    def save_checkpoint(self, path: str) -> None:
        """Write the sampler's part of a payload (``_host_state``) as a
        ``.pt``."""
        torch.save(self._host_state(), path)

    def checkpoint_payload(self, epoch: int, val_loss: float) -> Dict:
        """The last/best payload: ``epoch``, ``_host_state``, ``opt_state``,
        ``step``, ``validation_loss``, the generator states and, during
        ``train``, the train loader's state."""
        opt = self.opt.state()
        opt_state = {k: ({n: t.detach().cpu() for n, t in zip(
            self.param_names, gather_full(v, self.shard_dims, self.mesh))}
            if isinstance(v, list) else v) for k, v in opt.items()}
        out = {"epoch": int(epoch), **self._host_state(), "opt_state": opt_state,
               "step": int(self.step), "validation_loss": float(val_loss),
               "generators": {"host": self.host_generator.get_state(),
                              "device": self.generator.get_state()}}
        if self.train_loader is not None:
            out["train_loader"] = self.train_loader.state()
        return out

    @torch.no_grad()
    def load_payload(self, payload: Dict) -> None:
        """Restore params, EMA (when both the run and the payload have it,
        as the JAX ``_restore``), optimizer state, step and generator states
        from a last/best payload."""
        opt = {k: (local_shards([v[n] for n in self.param_names], self.shard_dims, self.mesh)
                   if isinstance(v, dict) else v) for k, v in payload["opt_state"].items()}
        if ("acc" in opt) != (self.grad_accum > 1):
            raise ValueError("the checkpoint was written with gradient accumulation "
                             f"{'on' if 'acc' in opt else 'off'}; this run has "
                             f"grad_accumulate_step={self.grad_accum}")
        self.unet.load_state_dict(local_state_dict(payload["unet"], self.layout, self.mesh))
        if self.ema is not None and "ema_unet" in payload:
            torch._foreach_copy_(self.ema, [t.to(self.device) for t in local_shards(
                [payload["ema_unet"][n] for n in self.param_names], self.shard_dims,
                self.mesh)])
        self.opt.load_state(opt)
        self.step = int(payload["step"])
        self.host_generator.set_state(payload["generators"]["host"])
        self.generator.set_state(payload["generators"]["device"])

    def _restore(self) -> None:
        """Resume from ``load_model_path``: the state, the train loader's
        draws (which the JAX loops restart), ``start_epoch = epoch + 1``,
        ``best_val`` (the saved epoch's validation loss, as the JAX loops
        set it) and the loss history."""
        path = self.config["load_model_path"]
        if not os.path.exists(path):
            print(f"No checkpoint at {path}; training from scratch")
            return
        payload = ckpt.load_checkpoint(path)
        self.load_payload(payload)
        if "train_loader" in payload:
            self.train_loader.load_state(payload["train_loader"])
        self.start_epoch = int(payload["epoch"]) + 1
        self.best_val = float(payload["validation_loss"])
        prior = ckpt.load_loss_dict(self.save_path)
        if prior:
            self.loss_dict = prior
        print(f"Resumed from {path} at epoch {self.start_epoch}")

    # -------------------------------------------------------------- main loop

    def _prepare(self, train_loader) -> None:
        """Called once before the epochs (and before a resume) with the
        train loader: the LDM probes its latent on the first batch."""

    def _after_samples(self, val_loader, stats: Dict) -> None:
        """Called after each epoch's interval samples."""

    def train(self, train_loader, val_loader) -> None:
        if self.save_dict is None:
            self.save_dict, self.save_path = save_dirs(self.config, self.mesh)
        with profile_trace(self.config.get("profile_dir")), self.mesh:
            self._train_impl(train_loader, val_loader)

    def _train_impl(self, train_loader, val_loader) -> None:
        self.train_loader = train_loader
        self._prepare(train_loader)
        print(f"Diffusion U-Net parameters: {sum(p.numel() for p in self.params):,}")
        if self.config.get("load_model_path"):
            self._restore()

        interval = int(self.config.get("val_plot_interval", 10))
        show_bar = bool(self.config.get("progress_bar"))
        for epoch in range(self.start_epoch, self.n_epochs):
            t0 = time.perf_counter()
            stats = {"epoch": epoch, "wait_s": 0.0, "copy_s": 0.0}
            losses = []
            for imgs, labels in timed_batches(train_loader, self.device, stats, show_bar,
                                              f"Epoch {epoch + 1}"):
                losses.append(self.train_step(imgs, labels))
            train_loss = float(torch.stack(losses).mean())  # the epoch's one sync
            stats.update(train_s=time.perf_counter() - t0, steps=len(losses))

            t1 = time.perf_counter()
            gen = torch.Generator(device=self.device).manual_seed(
                self.seed + 10_000_000 + epoch)
            host = torch.Generator().manual_seed(self.seed + 10_000_000 + epoch)
            val_losses = []
            for batch in val_loader:
                imgs, labels = batch_to_device(batch, self.device)
                val_losses.append(self.val_step(imgs, labels, generator=gen,
                                                host_generator=host))
            val_loss = float(torch.stack(val_losses).mean())
            stats.update(val_s=time.perf_counter() - t1, val_steps=len(val_losses))

            self.loss_dict["rec_loss"].append(train_loss)
            self.loss_dict["val_rec_loss"].append(val_loss)
            print(
                f"Epoch {epoch + 1}/{self.n_epochs} | loss {train_loss:.4f} | "
                f"val {val_loss:.4f} | {time.perf_counter() - t0:.1f}s | "
                f"{stats['train_s'] * 1e3 / stats['steps']:.1f} ms a train step"
            )

            t2 = time.perf_counter()
            stats["saved"] = self._save_epoch_artifacts(epoch, val_loss)
            stats["save_s"] = time.perf_counter() - t2

            # the interval samples: the model row of data coordinate 0 (all of
            # its ranks: the model axis's blocks run collectives); rank 0 writes
            if (epoch + 1) % interval == 0 and self.mesh.coords[0] == 0:
                t3 = time.perf_counter()
                n = 16 if self.spatial_dims == 2 else self.samples_3d
                gen = torch.Generator(device=self.device).manual_seed(
                    self.seed + 20_000_000 + epoch)
                images = self.sample_images(n, sampler="ddim", generator=gen)
                if self.mesh.is_writer:
                    stats["samples"] = plots.save_samples(images, self.save_dict["plots"],
                                                          epoch, self.spatial_dims)
                stats["sample_s"] = time.perf_counter() - t3
                self._after_samples(val_loader, stats)
            self.epoch_stats.append(stats)

    def _save_epoch_artifacts(self, epoch, val_loss):
        """loss.png (when matplotlib is there), loss_dict.pkl, then last /
        best. Returns the checkpoint names written, the seconds of the
        payload's copy to the host and of the writes (rank 0 writes)."""
        if self.mesh.is_writer:
            plots.save_main_losses(
                self.loss_dict["rec_loss"], self.loss_dict["val_rec_loss"],
                os.path.join(self.save_dict["plots"], "loss.png"), title="Diffusion MSE",
            )
            ckpt.save_loss_dict(self.save_path, self.loss_dict)
        record = {"payload_s": 0.0}

        def payload():
            t = time.perf_counter()
            out = self.checkpoint_payload(epoch, val_loss)
            record["payload_s"] = time.perf_counter() - t
            return out

        t = time.perf_counter()
        record["names"] = save_last_best(self, epoch, val_loss, payload)
        record["write_s"] = time.perf_counter() - t - record["payload_s"]
        return record


def train_cli_parser(description: str) -> argparse.ArgumentParser:
    """The arguments the diffusion training CLIs share (the JAX
    ``parse_arguments``, plus the port's ``--device`` and ``--dtype``)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("dataset_id", type=str)
    parser.add_argument("splitting", choices=["train-val-test", "5-fold"])
    parser.add_argument("model_type", choices=["2d", "3d"])
    parser.add_argument("-f", "--fold", type=int, choices=range(6), default=None)
    parser.add_argument("-p", "--progress_bar", action="store_true")
    parser.add_argument("-c", "--continue_training", action="store_true")
    parser.add_argument(
        "--set", dest="overrides", action="append", default=None, metavar="KEY=VALUE",
        help="Override any config field, e.g. --set n_epochs=50 "
             "--set vae_params.num_res_blocks=3",
    )
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                        help="compute dtype of the networks (fp32 master params)")
    return parser


def parse_train_args(parser: argparse.ArgumentParser, argv: Optional[Sequence[str]] = None):
    args = parser.parse_args(argv)
    if args.splitting == "5-fold" and args.fold is None:
        parser.error("--fold is required when --splitting is '5-fold'")
    return args
