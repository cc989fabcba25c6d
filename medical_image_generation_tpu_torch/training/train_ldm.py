"""Latent diffusion training: ``LDMTrainer`` and the ``medimgen_torch_train_ldm`` CLI.

Port of ``LDMTrainer`` (``medical_image_generation_tpu/training/
train_ldm.py``): ``probe_latent`` (:163-176), the train step
(``_make_train_step``, :224-258), the validation step (:260-280), the
epoch loop (``train`` / ``_train_impl``, :444-514), the epoch artifacts and
resume (:516-568) and the CLI (:574-627), with the JAX trainer's names. One
``train_step`` runs, in order:

* device augmentation of the loader's (possibly enlarged) patch, cropped
  back to the final size (``data/augment.py``);
* the frozen stage-1 encode under ``no_grad``: the KL-VAE's posterior
  sample times ``scale_factor``, or the VQ-VAE's pre-quantization latent
  mapped from the codebook's [min, max] to [-1, 1] (``_scale``, JAX
  :125-155);
* ``t`` uniform in [0, T), noise, ``add_noise`` and the training target;
* optional classifier-free label dropout (labels replaced by the null class
  ``num_classes``);
* the U-Net forward in the compute dtype with fp32 master params, the loss
  ``mean((pred.f32 - target)^2)``, backward (the GroupNorm and attention
  kernels are autograd Functions with kernel backwards);
* ``clip_by_global_norm`` and AdamW with a bf16 first moment
  (``training/common.py``), wrapped in ``MultiSteps`` when
  ``grad_accumulate_step > 1``; then the EMA of the params, when on, on
  synced steps only.

It updates the params and the optimizer state in place and returns the fp32
loss as a device tensor (no host synchronisation). Random draws: the small
per-sample ones (augmentation, ``t``, dropout coins) come from a CPU
generator, the latent-sized ones (posterior ``eps``, noise) from a generator
on the device; ``draws`` replaces all of them, so a test can feed the JAX
step's own numbers. Validation and the interval samples draw from
generators seeded by the epoch, so they leave the training stream alone.

``train(train_loader, val_loader)`` runs the epochs over the host loaders
of ``data/loader.py``: each batch is copied to the card once (through a
pinned buffer, without blocking the host), each step's loss stays on the
device until the epoch's mean, validation runs every epoch, samples are
drawn every ``val_plot_interval`` epochs (EMA weights when EMA is on, as
the JAX ``_sampling_params``), and ``checkpoints/last_model.pt`` /
``best_model.pt`` follow ``common.save_last_best``. A last/best payload
mirrors the JAX one (``:522-534``): ``epoch``, ``unet`` (the live params,
JAX's ``params``), ``ema_unet`` (when EMA is on), ``opt_state`` (``mu``,
``nu``, ``count``, and MultiSteps' ``acc`` and ``mini_step``), ``step``
(microsteps), ``validation_loss``, ``scale_factor``, ``latent_shape``, the
frozen autoencoder under ``vae`` (``vq`` for the VQ latent space, so
``medimgen_torch_sample_ldm`` samples from the file directly), the states
of the trainer's two generators and the train loader's ``state`` (its
shuffle RNG and batch seed counter): a resumed run continues its draws and
its patient order (the JAX loop restarts its step counter at 0 and replays
step 0's keys, and builds a fresh loader).

Every ``val_plot_interval`` epochs, after the interval samples and when
``run_generation_eval`` is on (the default in 2D), ``evaluate_generation``
(JAX :358-440) scores the model: n samples (100 in 2D, 40 in 3D, at most
16 / 2 a ``sample_images`` call) from a generator seeded ``seed + 777``
with ``eval_sampler`` (default ``ddpm``, the full ancestral trajectory) and
``eval_num_inference_steps``, as many real images from the val loader, FID
over the cached ``FeatureExtractor``'s features, SSIM / MS-SSIM (window
``EVAL_SSIM_KERNEL``) over all C(n, 2) sample pairs, and with ``eval_mmd``
the MMD of the same features. The metrics and their seconds (sampling,
features, pairwise) go into the epoch's ``epoch_stats``.

Not ported, and refused before the first step: the augmentations that
``data/augment.py`` lacks.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from medical_image_generation_tpu_torch._device import resolve_device
from medical_image_generation_tpu_torch.config.run import (
    apply_overrides,
    create_save_path_dict,
    filter_config_by_mode,
    get_config_for_current_task,
    print_configuration,
)
from medical_image_generation_tpu_torch.data.augment import (
    AugmentConfig,
    AugmentDraws,
    augment_batch,
    center_crop_batch,
    check_ported,
    make_draws,
)
from medical_image_generation_tpu_torch.data.loader import get_data_loaders, unpack_batch
from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule
from medical_image_generation_tpu_torch.eval.features import FeatureExtractor
from medical_image_generation_tpu_torch.eval.fid import fid_from_features
from medical_image_generation_tpu_torch.eval.mmd import mmd_from_features
from medical_image_generation_tpu_torch.eval.ssim import pairwise_metrics
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.models.vqvae import VQVAE
from medical_image_generation_tpu_torch.planning.planner import compute_output_size
from medical_image_generation_tpu_torch.training import checkpoints as ckpt
from medical_image_generation_tpu_torch.training import common, plots
from medical_image_generation_tpu_torch.training.sample import LDMSampler
from medical_image_generation_tpu_torch.utils.profiling import StepTimer, profile_trace


class TrainDraws(NamedTuple):
    """Every random number of one train step. ``drop``: per-sample bool
    label-dropout coins, or None without class conditioning."""

    augment: AugmentDraws
    eps: Optional[torch.Tensor]  # posterior noise, latent-shaped (None: vq)
    t: torch.Tensor      # (B,) int64 timesteps
    noise: torch.Tensor  # diffusion noise, latent-shaped
    drop: Optional[torch.Tensor] = None


class LDMTrainer:
    """Stage-2 latent diffusion trainer over a frozen KL-VAE (or VQ-VAE, with
    ``latent_space_type="vq"``), held as ``vae``. Build with
    ``from_config``."""

    def __init__(self, config: dict, unet: DiffusionUNet, vae: AutoencoderKL | VQVAE,
                 device: str | torch.device = "cuda", seed: int = 0,
                 steps_per_epoch: int = 250, latent_space_type: str = "vae"):
        self.device = resolve_device(device)
        self.config = config
        self.seed = seed
        self.unet = unet.train()
        self.vae = vae.eval().requires_grad_(False)
        self.latent_space_type = latent_space_type
        self.vae_params = common.generator_params(config, latent_space_type)
        self.spatial_dims = self.vae_params["spatial_dims"]
        if latent_space_type == "vq":
            codebook = self.vae.quantizer.codebook
            self.codebook_min = float(codebook.min())
            self.codebook_max = float(codebook.max())
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
        check_ported(self.aug_cfg, self.spatial_dims)
        self.params = [p for p in self.unet.parameters() if p.requires_grad]
        self.param_names = [n for n, p in self.unet.named_parameters() if p.requires_grad]
        self.grad_accum = int(config.get("grad_accumulate_step", 1))
        self.opt = common.AdamW(
            self.params,
            common.make_lr_schedule(float(config.get("ddpm_learning_rate", 2e-5)),
                                    config.get("lr_scheduler"),
                                    config.get("lr_scheduler_params"), steps_per_epoch),
            clip=self.clip, weight_decay=1e-2, mu_dtype=common.mu_dtype_from_config(config))
        if self.grad_accum > 1:
            self.opt = common.MultiSteps(self.opt, self.grad_accum)
        self.ema = ([p.detach().clone() for p in self.params] if self.ema_decay else None)
        self.scale_factor = 1.0
        self.latent_shape = None
        self.host_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.step = 0  # microsteps taken (the JAX TrainState.step)
        # the epoch loop's state (JAX train_ldm.py:106-111)
        self.n_epochs = int(config.get("n_epochs", 100))
        self.loss_dict: Dict[str, list] = {"rec_loss": [], "val_rec_loss": []}
        self.start_epoch = 0
        self.best_val = float("inf")
        self.save_dict: Optional[Dict[str, str]] = None
        self.save_path: Optional[str] = None
        self.train_loader = None  # set by train(); its state goes into last/best
        self.timer = StepTimer("ldm_train")
        self.epoch_stats: list = []  # one dict of host-side seconds an epoch

    @staticmethod
    def from_config(config: dict, vae_state, unet_state=None,
                    device: str | torch.device = "cuda", dtype=torch.bfloat16, seed: int = 0,
                    steps_per_epoch: int = 250,
                    latent_space_type: str = "vae") -> "LDMTrainer":
        """U-Net with fp32 master params computing in ``dtype`` (flax-style
        initialisation from ``seed``, or ``unet_state``), and the frozen
        KL-VAE (VQ-VAE for ``vq``) from ``vae_state`` (computing in
        ``dtype``)."""
        dev = resolve_device(device)
        ddpm_params = dict(config["ddpm_params"])
        cc = config.get("class_conditioning") or None
        if cc:
            ddpm_params["num_class_embeds"] = int(cc["num_classes"]) + 1
        torch.manual_seed(seed)
        unet = DiffusionUNet.from_config(ddpm_params, dtype=dtype, param_dtype=torch.float32,
                                         device=dev)
        if unet_state is None:
            common.init_like_flax_(unet)
        else:
            unet.load_state_dict(unet_state)
        vae = common.build_generator(config, latent_space_type, dtype, device=dev)
        vae.load_state_dict(vae_state)
        return LDMTrainer(config, unet, vae, dev, seed, steps_per_epoch, latent_space_type)

    # ----------------------------------------------------------------- latent

    def _final_spatial(self, batch):
        crop = self.aug_cfg.crop_to
        return tuple(crop) if crop is not None else tuple(batch.shape[1:-1])

    def latent_shape_of(self, batch):
        """(B, *latent spatial, latent_channels) of a loader batch."""
        lat = compute_output_size(self._final_spatial(batch),
                                  self.vae_params["downsample_parameters"])
        ch = (self.vae_params["latent_channels"] if self.latent_space_type == "vae"
              else self.vae_params.get("embedding_dim", 8))
        return (batch.shape[0], *lat, ch)

    def _encode(self, imgs, eps):
        """Stage-2 latent of a batch, before scaling: a posterior sample
        (KL-VAE) or the pre-quantization latent (VQ-VAE)."""
        if self.latent_space_type == "vae":
            return self.vae.encode_stage_2_inputs(imgs, eps)
        return self.vae.encode_stage_2_inputs(imgs)

    def _scale(self, z):
        if self.latent_space_type == "vae":
            return z * self.scale_factor
        lo, hi = self.codebook_min, self.codebook_max
        return 2 * (z - lo) / (hi - lo) - 1

    @torch.no_grad()
    def probe_latent(self, batch, generator: Optional[torch.Generator] = None):
        """Fix the latent shape and (KL-VAE) ``scale_factor = 1 / (std(z) +
        1e-8)`` from one (center-cropped) batch. The posterior noise comes
        from ``generator``, else from a generator seeded 0 (the JAX probe's
        ``PRNGKey(0)``), never from the training stream. The VQ latent
        keeps ``scale_factor`` 1 (its range is the codebook's)."""
        batch = center_crop_batch(batch.to(self.device), self._final_spatial(batch))
        eps = None
        if self.latent_space_type == "vae":
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            eps = torch.randn(self.latent_shape_of(batch), device=self.device,
                              generator=generator)
        z = self._encode(batch, eps)
        if self.latent_space_type == "vae":
            self.scale_factor = float(1.0 / (z.std(correction=0) + 1e-8))
        self.latent_shape = tuple(z.shape)
        return self.scale_factor, self.latent_shape

    # ------------------------------------------------------------------ steps

    def make_draws(self, batch, labels=None, generator: Optional[torch.Generator] = None,
                   host_generator: Optional[torch.Generator] = None) -> TrainDraws:
        B = batch.shape[0]
        lat = self.latent_shape_of(batch)
        gen = generator or self.generator
        host = host_generator or self.host_generator
        return TrainDraws(
            augment=make_draws(self.aug_cfg, B, batch.shape[-1], batch.dim() - 2, host),
            eps=(torch.randn(lat, device=self.device, generator=gen)
                 if self.latent_space_type == "vae" else None),
            t=torch.randint(0, self.schedule.num_train_timesteps, (B,), generator=host),
            noise=torch.randn(lat, device=self.device, generator=gen),
            drop=(torch.rand((B,), generator=host) < self.cfg_dropout
                  if labels is not None and self.class_cond else None))

    def _noised(self, imgs, draws: TrainDraws):
        with torch.no_grad():
            eps = None if draws.eps is None else draws.eps.to(self.device)
            z = self._scale(self._encode(imgs, eps)).float()
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
        synced = self.opt.step([p.grad for p in self.params])
        if self.ema is not None and synced:
            common.ema_update(self.ema, self.params, float(self.ema_decay))
        self.step += 1
        return loss.detach()

    @torch.no_grad()
    def val_step(self, batch, labels=None, generator: Optional[torch.Generator] = None,
                 draws: Optional[TrainDraws] = None,
                 host_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Loss on a final-size batch: no augmentation, no label dropout."""
        batch = batch.to(self.device)
        if draws is None:
            draws = self.make_draws(batch, None, generator, host_generator)
        noisy, target, t = self._noised(batch, draws)
        lab = labels.to(self.device) if labels is not None and self.class_cond else None
        pred = self.unet(noisy, t, class_labels=lab)
        return torch.mean((pred.float() - target) ** 2)

    # ---------------------------------------------------------------- sampling

    @contextlib.contextmanager
    def sampling_weights(self):
        """The U-Net in eval mode with the EMA weights swapped in when EMA
        is on (the JAX ``_sampling_params``, train_ldm.py:284-287); the live
        params and train mode come back on exit. The swap moves tensor
        handles, not data."""
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
        """``n_samples`` decoded images (n, *spatial, C) in [0, 1] through
        ``LDMSampler`` with the sampling weights."""
        if self.latent_shape is None:
            raise RuntimeError("call probe_latent first: sampling needs the latent shape")
        cc = self.class_cond or {}
        with self.sampling_weights() as unet:
            out = LDMSampler(unet, self.vae, self.schedule, self.scale_factor, self.latent_shape,
                             self.num_classes if self.class_cond else None,
                             float(cc.get("guidance_scale", 2.0)), self.device,
                             self.latent_space_type).sample(
                n_samples, sampler=sampler, num_inference_steps=num_inference_steps,
                generator=generator)
        return out

    # -------------------------------------------------------------- eval

    # the reference protocol builds MONAI's SSIM and MS-SSIM with kernel_size=4
    EVAL_SSIM_KERNEL = 4

    @property
    def feature_extractor(self) -> FeatureExtractor:
        """The FID extractor, built once a trainer (JAX train_ldm.py:
        358-367)."""
        if getattr(self, "_extractor", None) is None:
            self._extractor = FeatureExtractor(spatial_dims=self.spatial_dims, device=self.device)
        return self._extractor

    def evaluate_generation(self, val_loader, n_samples: Optional[int] = None,
                            generator: Optional[torch.Generator] = None) -> Dict:
        """The generative eval (JAX train_ldm.py:373-440): FID between
        ``n_samples`` samples and as many val images, pairwise SSIM / MS-SSIM
        over every pair of samples, and MMD with ``eval_mmd``. Prints the
        JAX line; returns the metrics and ``seconds`` {sampling, features,
        pairwise}."""
        if n_samples is None:
            n_samples = 100 if self.spatial_dims == 2 else 40
        gen = generator or torch.Generator(device=self.device).manual_seed(self.seed + 777)
        sampler = str(self.config.get("eval_sampler", "ddpm"))
        num_steps = self.config.get("eval_num_inference_steps")
        cap = 16 if self.spatial_dims == 2 else 2
        t0 = time.perf_counter()
        samples, remaining = [], n_samples
        while remaining > 0:
            take = min(cap, remaining)
            samples.append(self.sample_images(take, sampler=sampler,
                                              num_inference_steps=num_steps, generator=gen))
            remaining -= take
        fake = np.concatenate(samples, axis=0)
        t1 = time.perf_counter()
        real = []
        for batch in val_loader:
            real.append(np.asarray(unpack_batch(batch)[0]))
            if sum(r.shape[0] for r in real) >= n_samples:
                break
        real = np.concatenate(real, axis=0)[:n_samples]
        extractor = self.feature_extractor
        feats_real, feats_fake = extractor(real), extractor(fake)
        t2 = time.perf_counter()
        fid = fid_from_features(feats_real, feats_fake)
        t3 = time.perf_counter()
        pw = pairwise_metrics(torch.from_numpy(fake).to(self.device),
                              win_size=self.EVAL_SSIM_KERNEL)
        t4 = time.perf_counter()
        metrics = {"fid": float(fid), "ssim": pw["ssim_mean"], "ssim_std": pw["ssim_std"],
                   "ms_ssim": pw["ms_ssim_mean"], "ms_ssim_std": pw["ms_ssim_std"],
                   "n_pairs": pw["n_pairs"]}
        if self.config.get("eval_mmd"):
            metrics["mmd"] = mmd_from_features(feats_real, feats_fake)
        metrics["seconds"] = {"sampling": t1 - t0, "features": t2 - t1, "fid": t3 - t2,
                              "pairwise": t4 - t3, "mmd": time.perf_counter() - t4}
        print(
            f"FID: {metrics['fid']:.4f} - "
            f"MS-SSIM: {metrics['ms_ssim']:.4f} +- {metrics['ms_ssim_std']:.4f} - "
            f"SSIM: {metrics['ssim']:.4f} +- {metrics['ssim_std']:.4f} "
            f"({metrics['n_pairs']} pairs)"
            + (f" - MMD: {metrics['mmd']:.6f}" if "mmd" in metrics else "")
        )
        return metrics

    # ------------------------------------------------------------ checkpoint

    def _host_state(self):
        """The sampler's part of a payload: ``unet`` (the live params),
        ``ema_unet`` when EMA is on, ``vae`` (``vq``), ``scale_factor``,
        ``latent_shape``; every tensor copied to the CPU."""
        if self.latent_shape is None:
            raise RuntimeError("call probe_latent first: the checkpoint needs the latent shape")
        out = {"unet": {k: v.detach().cpu() for k, v in self.unet.state_dict().items()}}
        if self.ema is not None:
            out["ema_unet"] = {n: e.cpu() for n, e in zip(self.param_names, self.ema)}
        out[self.latent_space_type] = {k: v.cpu() for k, v in self.vae.state_dict().items()}
        out.update(scale_factor=float(self.scale_factor),
                   latent_shape=[int(v) for v in self.latent_shape])
        return out

    def save_checkpoint(self, path: str) -> None:
        """Write the ``.pt`` that ``training.sample.load_torch_checkpoint``
        reads: ``unet`` (the live params, which ``medimgen_torch_sample_ldm``
        samples, as the JAX sampling CLI samples ``params``), ``ema_unet``
        when EMA is on, ``vae`` (``vq``), ``scale_factor``, ``latent_shape``."""
        torch.save(self._host_state(), path)

    def checkpoint_payload(self, epoch: int, val_loss: float) -> Dict:
        """The last/best payload (JAX train_ldm.py:522-534 plus ``vae``,
        the generator states and, during ``train``, the train loader's
        state)."""
        opt = self.opt.state()
        opt_state = {k: ({n: t.detach().cpu() for n, t in zip(self.param_names, v)}
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
        as the JAX ``_restore``), optimizer state, step, scale factor and
        generator states from a last/best payload."""
        opt = {k: ([v[n] for n in self.param_names] if isinstance(v, dict) else v)
               for k, v in payload["opt_state"].items()}
        if ("acc" in opt) != (self.grad_accum > 1):
            raise ValueError("the checkpoint was written with gradient accumulation "
                             f"{'on' if 'acc' in opt else 'off'}; this run has "
                             f"grad_accumulate_step={self.grad_accum}")
        self.unet.load_state_dict(payload["unet"])
        if self.ema is not None and "ema_unet" in payload:
            torch._foreach_copy_(self.ema, [payload["ema_unet"][n].to(self.device)
                                            for n in self.param_names])
        self.opt.load_state(opt)
        self.step = int(payload["step"])
        self.scale_factor = float(payload["scale_factor"])
        self.host_generator.set_state(payload["generators"]["host"])
        self.generator.set_state(payload["generators"]["device"])

    def _restore(self) -> None:
        """Resume from ``load_model_path`` (JAX train_ldm.py:536-568):
        the state, the train loader's draws (which the JAX loop restarts),
        ``start_epoch = epoch + 1``, ``best_val`` (the saved
        epoch's validation loss, as the JAX loop sets it) and the loss
        history."""
        path = self.config["load_model_path"]
        if not os.path.exists(path):
            print(f"No checkpoint at {path}; training from scratch")
            return
        payload = ckpt.load_checkpoint(path)
        self.load_payload(payload)
        if "train_loader" in payload:  # after the probe, which moved the loader
            self.train_loader.load_state(payload["train_loader"])
        self.start_epoch = int(payload["epoch"]) + 1
        self.best_val = float(payload["validation_loss"])
        prior = ckpt.load_loss_dict(self.save_path)
        if prior:
            self.loss_dict = prior
        print(f"Resumed from {path} at epoch {self.start_epoch}")

    # -------------------------------------------------------------- main loop

    def train(self, train_loader, val_loader) -> None:
        if self.save_dict is None:
            self.save_dict, self.save_path = create_save_path_dict(self.config)
        with profile_trace(self.config.get("profile_dir")):
            self._train_impl(train_loader, val_loader)

    def _train_impl(self, train_loader, val_loader) -> None:
        self.train_loader = train_loader
        first = common.batch_to_device(next(iter(train_loader)), self.device)[0]
        scale, shape = self.probe_latent(first)
        print(f"Scaling factor set to {scale}")
        print(f"Latent shape: {shape}")
        del first
        print(f"Diffusion U-Net parameters: {sum(p.numel() for p in self.params):,}")
        if self.config.get("load_model_path"):
            self._restore()

        interval = int(self.config.get("val_plot_interval", 10))
        show_bar = bool(self.config.get("progress_bar"))
        for epoch in range(self.start_epoch, self.n_epochs):
            t0 = time.perf_counter()
            stats = {"epoch": epoch, "wait_s": 0.0, "copy_s": 0.0}
            losses = []
            self.timer.start()
            for imgs, labels in common.timed_batches(train_loader, self.device, stats,
                                                     show_bar, f"Epoch {epoch + 1}"):
                losses.append(self.train_step(imgs, labels))
                self.timer.tick()
            train_loss = float(torch.stack(losses).mean())  # the epoch's one sync
            stats.update(train_s=time.perf_counter() - t0, steps=len(losses))

            t1 = time.perf_counter()
            gen = torch.Generator(device=self.device).manual_seed(
                self.seed + 10_000_000 + epoch)
            host = torch.Generator().manual_seed(self.seed + 10_000_000 + epoch)
            val_losses = []
            for batch in val_loader:
                imgs, labels = common.batch_to_device(batch, self.device)
                val_losses.append(self.val_step(imgs, labels, generator=gen,
                                                host_generator=host))
            val_loss = float(torch.stack(val_losses).mean())
            stats.update(val_s=time.perf_counter() - t1, val_steps=len(val_losses))

            self.loss_dict["rec_loss"].append(train_loss)
            self.loss_dict["val_rec_loss"].append(val_loss)
            print(
                f"Epoch {epoch + 1}/{self.n_epochs} | loss {train_loss:.4f} | "
                f"val {val_loss:.4f} | {time.perf_counter() - t0:.1f}s | {self.timer.report()}"
            )

            t2 = time.perf_counter()
            stats["saved"] = self._save_epoch_artifacts(epoch, val_loss)
            stats["save_s"] = time.perf_counter() - t2

            if (epoch + 1) % interval == 0:
                t3 = time.perf_counter()
                n = 16 if self.spatial_dims == 2 else 2
                gen = torch.Generator(device=self.device).manual_seed(
                    self.seed + 20_000_000 + epoch)
                images = self.sample_images(n, sampler="ddim", generator=gen)
                stats["samples"] = plots.save_samples(images, self.save_dict["plots"], epoch,
                                                      self.spatial_dims)
                stats["sample_s"] = time.perf_counter() - t3
                if self.config.get("run_generation_eval", self.spatial_dims == 2):
                    t4 = time.perf_counter()
                    stats["eval"] = self.evaluate_generation(val_loader)
                    stats["eval_s"] = time.perf_counter() - t4
            self.epoch_stats.append(stats)

    def _save_epoch_artifacts(self, epoch, val_loss):
        """loss.png (when matplotlib is there), loss_dict.pkl, then last /
        best. Returns the checkpoint names written, the seconds of the
        payload's copy to the host and of the writes."""
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
        record["names"] = common.save_last_best(self, epoch, val_loss, payload)
        record["write_s"] = time.perf_counter() - t - record["payload_s"]
        return record


# --------------------------------------------------------------------- CLI

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def parse_arguments(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Train a Latent Diffusion Model (PyTorch port).")
    parser.add_argument("dataset_id", type=str)
    parser.add_argument("splitting", choices=["train-val-test", "5-fold"])
    parser.add_argument("model_type", choices=["2d", "3d"])
    parser.add_argument("-f", "--fold", type=int, choices=range(6), default=None)
    parser.add_argument("-l", "--latent_space_type", default="vae", choices=["vae", "vq"])
    parser.add_argument("-p", "--progress_bar", action="store_true")
    parser.add_argument("-c", "--continue_training", action="store_true")
    parser.add_argument(
        "--set", dest="overrides", action="append", default=None, metavar="KEY=VALUE",
        help="Override any config field, e.g. --set n_epochs=50 "
             "--set vae_params.num_res_blocks=3",
    )
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16",
                        help="compute dtype of the U-Net and the frozen VAE (fp32 master params)")
    args = parser.parse_args(argv)
    if args.splitting == "5-fold" and args.fold is None:
        parser.error("--fold is required when --splitting is '5-fold'")
    return args


def run_cli(argv: Optional[Sequence[str]] = None) -> LDMTrainer:
    """``medimgen_torch_train_ldm``: the JAX ``main`` (train_ldm.py:
    585-627) on the port; returns the trainer after training. Everything
    the port cannot do is refused here, before the first step."""
    args = parse_arguments(argv)
    device = resolve_device(args.device)
    config = get_config_for_current_task(
        args.dataset_id, args.model_type, "ldm",
        progress_bar=args.progress_bar, continue_training=args.continue_training,
    )
    # filter BEFORE overrides, latent_space_type first (as the JAX CLI)
    config["latent_space_type"] = args.latent_space_type
    config = filter_config_by_mode(config, "train_ldm")
    config = apply_overrides(config, args.overrides)
    if config.get("latent_space_type") != args.latent_space_type:
        raise ValueError(f"--set latent_space_type={config.get('latent_space_type')!r} "
                         f"disagrees with -l {args.latent_space_type}")
    # the LDM consumes the AE's best checkpoint (reference train_ldm.py:631-636)
    results_root = os.getenv("medimgen_results")
    ae_best = os.path.join(results_root, config["task"], args.model_type, "autoencoder",
                           "checkpoints", "best_model.pt")
    if not os.path.exists(ae_best):
        raise FileNotFoundError(f"Train the autoencoder first: no checkpoint at {ae_best} "
                                "(medimgen_torch_train_autoencoder writes it; "
                                "tools/orbax_to_torch.py converts a JAX best_model)")
    config["load_autoencoder_path"] = ae_best
    print_configuration(config, config["results_path"], "train", model="ldm")
    print(f"Loading autoencoder checkpoint from {ae_best}...")
    ae = ckpt.load_checkpoint(ae_best)
    print(f"Autoencoder epoch: {ae.get('epoch')}")
    key = args.latent_space_type
    if key not in ae:
        raise KeyError(f"{ae_best} holds no {key!r} autoencoder (keys {sorted(ae)}): "
                       f"trained with another -l?")
    train_loader, val_loader = get_data_loaders(
        config, args.dataset_id, args.splitting, config["ddpm_batch_size"],
        args.model_type, config["ddpm_transformations"], args.fold,
    )
    trainer = LDMTrainer.from_config(config, ae[key], device=device,
                                     dtype=_DTYPES[args.dtype], seed=0,
                                     steps_per_epoch=len(train_loader),
                                     latent_space_type=key)
    del ae
    trainer.train(train_loader, val_loader)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    run_cli(argv)


if __name__ == "__main__":
    main()
