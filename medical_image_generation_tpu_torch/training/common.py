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
  and the epoch loop's batches with the host seconds of waiting and copying.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from medical_image_generation_tpu_torch.data.loader import unpack_batch
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.vqvae import VQVAE
from medical_image_generation_tpu_torch.utils.profiling import maybe_progress


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
    def step(self, grads: List[Optional[torch.Tensor]]) -> bool:
        """A None gradient (a param the loss did not reach, such as the
        class embedding of a step without labels) counts as zeros, as
        ``jax.grad`` gives optax: the param is still decayed. Returns True
        (every step updates the params)."""
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                 for g, p in zip(grads, self.params)]
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
        self.inner.step(self.acc)  # clips the mean in place, then AdamW
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
    written."""
    from medical_image_generation_tpu_torch.training import checkpoints as ckpt

    improved = val_loss < trainer.best_val
    interval = max(1, int(trainer.config.get("checkpoint_interval", 1)))
    best_interval = max(1, int(trainer.config.get("best_checkpoint_interval", 1)))
    last_epoch = epoch + 1 >= trainer.n_epochs
    want_last = (epoch + 1) % interval == 0 or last_epoch
    want_best = improved and ((epoch + 1) % best_interval == 0 or last_epoch)
    if not (want_best or want_last):
        return []
    payload = payload_fn()
    if want_last:
        ckpt.save_checkpoint(trainer.save_dict["checkpoints"], "last_model", payload)
    if want_best:
        trainer.best_val = val_loss
        ckpt.save_checkpoint(trainer.save_dict["checkpoints"], "best_model", payload)
    return ["last_model"] * want_last + ["best_model"] * want_best


def batch_to_device(batch, device: torch.device):
    """A loader batch (array or {"image", "class"}) -> (images, labels or
    None) on ``device``, each copied once: through a pinned buffer without
    blocking the host on the card, or directly on the CPU."""
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
