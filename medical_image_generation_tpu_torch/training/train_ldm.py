"""Latent diffusion training step: ``LDMTrainer``.

Port of ``LDMTrainer`` (``medical_image_generation_tpu/training/
train_ldm.py``): ``probe_latent`` (:163-176), the train step
(``_make_train_step``, :224-258) and the validation step (:260-280), with
the JAX trainer's names. One ``train_step`` runs, in order:

* device augmentation of the loader's (possibly enlarged) patch, cropped
  back to the final size (``data/augment.py``);
* the frozen KL-VAE encode and posterior sample under ``no_grad``, times
  ``scale_factor``;
* ``t`` uniform in [0, T), noise, ``add_noise`` and the training target;
* optional classifier-free label dropout (labels replaced by the null class
  ``num_classes``);
* the U-Net forward in the compute dtype with fp32 master params, the loss
  ``mean((pred.f32 - target)^2)``, backward (the GroupNorm and attention
  kernels are autograd Functions with kernel backwards);
* ``clip_by_global_norm`` and AdamW with a bf16 first moment
  (``training/common.py``), then the optional EMA of the params.

It updates the params and the optimizer state in place and returns the fp32
loss as a device tensor (no host synchronisation). Random draws: the small
per-sample ones (augmentation, ``t``, dropout coins) come from a CPU
generator, the latent-sized ones (posterior ``eps``, noise) from a generator
on the device; ``draws`` replaces all of them, so a test can feed the JAX
step's own numbers.

Batches are tensors (the host data pipeline, the ``medimgen_train_ldm``
CLI, validation with FID/SSIM and checkpoint resume are not ported yet).
Gradient accumulation (``grad_accumulate_step > 1``) raises.
``save_checkpoint`` writes the ``.pt`` that ``training/sample.py``
(``LDMSampler``, ``medimgen_torch_sample_ldm``) reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from medical_image_generation_tpu_torch._device import resolve_device
from medical_image_generation_tpu_torch.data.augment import (
    AugmentConfig,
    AugmentDraws,
    augment_batch,
    center_crop_batch,
    make_draws,
)
from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.planning.planner import compute_output_size
from medical_image_generation_tpu_torch.training import common


class TrainDraws(NamedTuple):
    """Every random number of one train step. ``drop``: per-sample bool
    label-dropout coins, or None without class conditioning."""

    augment: AugmentDraws
    eps: torch.Tensor    # posterior noise, latent-shaped
    t: torch.Tensor      # (B,) int64 timesteps
    noise: torch.Tensor  # diffusion noise, latent-shaped
    drop: Optional[torch.Tensor] = None


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


class LDMTrainer:
    """Stage-2 latent diffusion trainer over a frozen KL-VAE. Build with
    ``from_config``."""

    def __init__(self, config: dict, unet: DiffusionUNet, vae: AutoencoderKL,
                 device: str | torch.device = "cuda", seed: int = 0,
                 steps_per_epoch: int = 250):
        self.device = resolve_device(device)
        self.config = config
        if int(config.get("grad_accumulate_step", 1)) > 1:
            raise NotImplementedError("grad_accumulate_step > 1 (optax.MultiSteps) is not "
                                      "ported yet")
        self.unet = unet.train()
        self.vae = vae.eval().requires_grad_(False)
        self.vae_params = config["vae_params"]
        self.spatial_dims = self.vae_params["spatial_dims"]
        self.schedule = NoiseSchedule.from_config(config["time_scheduler_params"],
                                                  device=self.device)
        self.class_cond = config.get("class_conditioning") or None
        if self.class_cond:
            self.num_classes = int(self.class_cond["num_classes"])
            self.cfg_dropout = float(self.class_cond.get("dropout_prob", 0.1))
        self.ema_decay = config.get("ema_decay")
        self.clip = float(config.get("grad_clip_max_norm", 1.0))
        self.aug_cfg = AugmentConfig.from_transformations(
            config.get("ddpm_transformations", {}), spatial_dims=self.spatial_dims)
        self.params = [p for p in self.unet.parameters() if p.requires_grad]
        self.opt = common.AdamW(
            self.params,
            common.make_lr_schedule(float(config.get("ddpm_learning_rate", 2e-5)),
                                    config.get("lr_scheduler"),
                                    config.get("lr_scheduler_params"), steps_per_epoch),
            clip=self.clip, weight_decay=1e-2, mu_dtype=common.mu_dtype_from_config(config))
        self.ema = ([p.detach().clone() for p in self.params] if self.ema_decay else None)
        self.scale_factor = 1.0
        self.latent_shape = None
        self.host_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    @staticmethod
    def from_config(config: dict, vae_state, unet_state=None,
                    device: str | torch.device = "cuda", dtype=torch.bfloat16, seed: int = 0,
                    steps_per_epoch: int = 250) -> "LDMTrainer":
        """U-Net with fp32 master params computing in ``dtype`` (flax-style
        initialisation from ``seed``, or ``unet_state``), and the frozen
        KL-VAE from ``vae_state`` (computing in ``dtype``)."""
        dev = resolve_device(device)
        ddpm_params = dict(config["ddpm_params"])
        cc = config.get("class_conditioning") or None
        if cc:
            ddpm_params["num_class_embeds"] = int(cc["num_classes"]) + 1
        torch.manual_seed(seed)
        unet = DiffusionUNet.from_config(ddpm_params, dtype=dtype, param_dtype=torch.float32,
                                         device=dev)
        if unet_state is None:
            init_like_flax_(unet)
        else:
            unet.load_state_dict(unet_state)
        vae = AutoencoderKL.from_config(config["vae_params"], dtype=dtype, device=dev)
        vae.load_state_dict(vae_state)
        return LDMTrainer(config, unet, vae, dev, seed, steps_per_epoch)

    # ----------------------------------------------------------------- latent

    def _final_spatial(self, batch):
        crop = self.aug_cfg.crop_to
        return tuple(crop) if crop is not None else tuple(batch.shape[1:-1])

    def latent_shape_of(self, batch):
        """(B, *latent spatial, latent_channels) of a loader batch."""
        lat = compute_output_size(self._final_spatial(batch),
                                  self.vae_params["downsample_parameters"])
        return (batch.shape[0], *lat, self.vae_params["latent_channels"])

    @torch.no_grad()
    def probe_latent(self, batch, generator: Optional[torch.Generator] = None):
        """Fix the latent shape and ``scale_factor = 1 / (std(z) + 1e-8)``
        from one (center-cropped) batch."""
        batch = center_crop_batch(batch.to(self.device), self._final_spatial(batch))
        eps = torch.randn(self.latent_shape_of(batch), device=self.device,
                          generator=generator or self.generator)
        z = self.vae.encode_stage_2_inputs(batch, eps)
        self.scale_factor = float(1.0 / (z.std(correction=0) + 1e-8))
        self.latent_shape = tuple(z.shape)
        return self.scale_factor, self.latent_shape

    # ------------------------------------------------------------------ steps

    def make_draws(self, batch, labels=None,
                   generator: Optional[torch.Generator] = None) -> TrainDraws:
        B = batch.shape[0]
        lat = self.latent_shape_of(batch)
        gen = generator or self.generator
        host = self.host_generator
        return TrainDraws(
            augment=make_draws(self.aug_cfg, B, batch.shape[-1], batch.dim() - 2, host),
            eps=torch.randn(lat, device=self.device, generator=gen),
            t=torch.randint(0, self.schedule.num_train_timesteps, (B,), generator=host),
            noise=torch.randn(lat, device=self.device, generator=gen),
            drop=(torch.rand((B,), generator=host) < self.cfg_dropout
                  if labels is not None and self.class_cond else None))

    def _noised(self, imgs, draws: TrainDraws):
        with torch.no_grad():
            z = self.vae.encode_stage_2_inputs(imgs, draws.eps.to(self.device))
            z = (z * self.scale_factor).float()
        t = draws.t.to(self.device)
        noise = draws.noise.to(self.device)
        return (self.schedule.add_noise(z, noise, t),
                self.schedule.training_target(z, noise, t), t)

    def train_step(self, batch, labels=None, generator: Optional[torch.Generator] = None,
                   draws: Optional[TrainDraws] = None) -> torch.Tensor:
        """One optimizer step on a (B, *spatial_in, C) batch in [0, 1];
        returns the loss (fp32 device scalar)."""
        batch = batch.to(self.device)
        if draws is None:
            draws = self.make_draws(batch, labels, generator)
        imgs = augment_batch(batch, draws.augment, self.aug_cfg)
        noisy, target, t = self._noised(imgs, draws)
        labels_in = None
        if labels is not None and self.class_cond:
            labels_in = labels.to(self.device)
            if draws.drop is not None:
                labels_in = torch.where(draws.drop.to(self.device),
                                        torch.full_like(labels_in, self.num_classes), labels_in)
        for p in self.params:
            p.grad = None
        pred = self.unet(noisy, t, class_labels=labels_in)
        loss = torch.mean((pred.float() - target) ** 2)
        loss.backward()
        self.opt.step([p.grad for p in self.params])
        if self.ema is not None:
            common.ema_update(self.ema, self.params, float(self.ema_decay))
        return loss.detach()

    @torch.no_grad()
    def val_step(self, batch, labels=None, generator: Optional[torch.Generator] = None,
                 draws: Optional[TrainDraws] = None) -> torch.Tensor:
        """Loss on a final-size batch: no augmentation, no label dropout."""
        batch = batch.to(self.device)
        if draws is None:
            draws = self.make_draws(batch, None, generator)
        noisy, target, t = self._noised(batch, draws)
        lab = labels.to(self.device) if labels is not None and self.class_cond else None
        pred = self.unet(noisy, t, class_labels=lab)
        return torch.mean((pred.float() - target) ** 2)

    # ------------------------------------------------------------ checkpoint

    def unet_state_for_sampling(self):
        """The U-Net state_dict with the EMA weights when EMA is on."""
        sd = {k: v.detach() for k, v in self.unet.state_dict().items()}
        if self.ema is not None:
            names = [n for n, p in self.unet.named_parameters() if p.requires_grad]
            sd.update(zip(names, self.ema))
        return sd

    def save_checkpoint(self, path: str) -> None:
        """Write the ``.pt`` that ``training.sample.load_torch_checkpoint``
        reads: ``unet`` (EMA weights when on), ``vae``, ``scale_factor``,
        ``latent_shape``."""
        if self.latent_shape is None:
            raise RuntimeError("call probe_latent first: the checkpoint needs the latent shape")
        torch.save({
            "unet": {k: v.cpu() for k, v in self.unet_state_for_sampling().items()},
            "vae": {k: v.cpu() for k, v in self.vae.state_dict().items()},
            "scale_factor": float(self.scale_factor),
            "latent_shape": [int(v) for v in self.latent_shape],
        }, path)
