"""Latent diffusion training: ``LDMTrainer`` and the ``medimgen_torch_train_ldm`` CLI.

Port of ``LDMTrainer`` (``medical_image_generation_tpu/training/
train_ldm.py``): ``probe_latent`` (:163-176), the train step
(``_make_train_step``, :224-258), the validation step (:260-280), the
epoch loop (``train`` / ``_train_impl``, :444-514), the epoch artifacts and
resume (:516-568) and the CLI (:574-627), with the JAX trainer's names. The
step, the loop, the payload and the resume are ``common.DiffusionTrainer``'s,
which the pixel-space DDPM (``training/train_ddpm.py``) shares; this module
adds the frozen autoencoder, the latent probe and scale, the decoded samples
and the generative eval. One ``train_step`` runs, in order:

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

``latent_space_type="precomputed"`` trains on latents a stage-1 model
computed beforehand, as MAISI's bundle does (``diff_model_create_training_data``
writes them, ``diff_model_train`` reads them): no autoencoder is built or
run, a loader batch is (B, *latent spatial, latent channels) in the loader's
layout and is the clean latent as it is (no augmentation: a transformation
switched on in ``ddpm_transformations`` is refused), ``probe_latent`` sets
``scale_factor = 1 / std(z)`` of the first batch (``torch.std``'s unbiased
estimate, MAISI's ``calculate_scale_factor``), and a step scales and noises
it under ``medimgen.latent``. ``train_step(..., cond=...)`` passes MAISI's
region and spacing inputs to the U-Net. Sampling needs the decoder and is
refused in this mode.

Not ported, and refused before the first step: the augmentations that
``data/augment.py`` lacks.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from medical_image_generation_tpu_torch._device import resolve_device
from medical_image_generation_tpu_torch.config.run import (
    apply_overrides,
    filter_config_by_mode,
    get_config_for_current_task,
    print_configuration,
)
from medical_image_generation_tpu_torch.data.augment import center_crop_batch
from medical_image_generation_tpu_torch.data.loader import get_data_loaders, unpack_batch
from medical_image_generation_tpu_torch.eval.features import FeatureExtractor
from medical_image_generation_tpu_torch.eval.fid import fid_from_features
from medical_image_generation_tpu_torch.eval.mmd import mmd_from_features
from medical_image_generation_tpu_torch.eval.ssim import pairwise_metrics
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.models.vqvae import VQVAE
from medical_image_generation_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    maybe_initialize_distributed,
)
from medical_image_generation_tpu_torch.planning.planner import compute_output_size
from medical_image_generation_tpu_torch.training import checkpoints as ckpt
from medical_image_generation_tpu_torch.training import common
from medical_image_generation_tpu_torch.training.common import TrainDraws  # noqa: F401
from medical_image_generation_tpu_torch.training.sample import LDMSampler


AUGMENT_KEYS = ("rotation", "scaling", "mirror", "brightness", "contrast", "gamma",
                "gaussian_noise", "gaussian_blur", "low_resolution", "elastic")


class LDMTrainer(common.DiffusionTrainer):
    """Stage-2 latent diffusion trainer over a frozen KL-VAE (or VQ-VAE, with
    ``latent_space_type="vq"``), held as ``vae``, or on precomputed latents
    (``"precomputed"``, ``vae`` None). Build with ``from_config``."""

    samples_3d = 2

    def __init__(self, config: dict, unet: DiffusionUNet, vae: AutoencoderKL | VQVAE | None,
                 device: str | torch.device = "cuda", seed: int = 0,
                 steps_per_epoch: int = 250, latent_space_type: str = "vae",
                 mesh: Optional[Mesh] = None):
        precomputed = latent_space_type == "precomputed"
        if precomputed:
            on = [k for k in AUGMENT_KEYS if config.get("ddpm_transformations", {}).get(k)]
            if on:
                raise ValueError(f"precomputed latents are not augmented: switch off {on}")
        self.vae_params = (None if precomputed
                           else common.generator_params(config, latent_space_type))
        super().__init__(config, unet, config["ddpm_params"]["spatial_dims"] if precomputed
                         else self.vae_params["spatial_dims"], device, seed, steps_per_epoch,
                         mesh)
        self.vae = None if precomputed else vae.eval().requires_grad_(False)
        self.latent_space_type = latent_space_type
        self.augments = not precomputed
        self.posterior_eps = latent_space_type == "vae"
        if latent_space_type == "vq":
            codebook = self.vae.quantizer.codebook
            self.codebook_min = float(codebook.min())
            self.codebook_max = float(codebook.max())
        self.scale_factor = 1.0
        self.latent_shape = None

    @staticmethod
    def from_config(config: dict, vae_state, unet_state=None,
                    device: str | torch.device = "cuda", dtype=torch.bfloat16, seed: int = 0,
                    steps_per_epoch: int = 250, latent_space_type: str = "vae",
                    mesh: Optional[Mesh] = None) -> "LDMTrainer":
        """U-Net with fp32 master params computing in ``dtype`` (flax-style
        initialisation from ``seed``, or ``unet_state``), and the frozen
        KL-VAE (VQ-VAE for ``vq``) from ``vae_state`` (computing in
        ``dtype``; None for ``precomputed``); the trainer on ``mesh``
        (default: the config's)."""
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
        vae = None
        if latent_space_type != "precomputed":
            vae = common.build_generator(config, latent_space_type, dtype, device=dev)
            vae.load_state_dict(vae_state)
        return LDMTrainer(config, unet, vae, dev, seed, steps_per_epoch, latent_space_type, mesh)

    # ----------------------------------------------------------------- latent

    def latent_shape_of(self, batch):
        """(B, *latent spatial, latent_channels) of a loader batch."""
        if self.vae is None:
            return tuple(batch.shape)  # the batch is the latent
        lat = compute_output_size(self._final_spatial(batch),
                                  self.vae_params["downsample_parameters"])
        ch = (self.vae_params["latent_channels"] if self.latent_space_type == "vae"
              else self.vae_params.get("embedding_dim", 8))
        return (batch.shape[0], *lat, ch)

    def _encode(self, imgs, eps):
        """Stage-2 latent of a batch, before scaling: a posterior sample
        (KL-VAE), the pre-quantization latent (VQ-VAE), or the batch itself
        (precomputed)."""
        if self.vae is None:
            return imgs
        if self.latent_space_type == "vae":
            return self.vae.encode_stage_2_inputs(imgs, eps)
        return self.vae.encode_stage_2_inputs(imgs)

    def _scale(self, z):
        if self.latent_space_type != "vq":
            return z * self.scale_factor
        lo, hi = self.codebook_min, self.codebook_max
        return 2 * (z - lo) / (hi - lo) - 1

    @torch.no_grad()
    def probe_latent(self, batch, generator: Optional[torch.Generator] = None):
        """Fix the latent shape and (KL-VAE) ``scale_factor = 1 / (std(z) +
        1e-8)`` from one (center-cropped) batch. The posterior noise comes
        from ``generator``, else from a generator seeded 0 (the JAX probe's
        ``PRNGKey(0)``), never from the training stream. The VQ latent
        keeps ``scale_factor`` 1 (its range is the codebook's); precomputed
        latents take MAISI's ``1 / std(z)`` (unbiased, no epsilon). In a
        data-parallel run ``batch`` is this rank's rows: the noise is drawn
        for the global batch and the latents are gathered over the data
        axis, so every rank gets the one-process probe's numbers."""
        batch = center_crop_batch(batch.to(self.device), self._final_spatial(batch))
        eps = None
        if self.latent_space_type == "vae":
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            shape = self.latent_shape_of(batch)
            eps = common.local_rows(torch.randn(
                (shape[0] * self.mesh.shape["data"], *shape[1:]), device=self.device,
                generator=generator), self.mesh)
        z = self.data_axis.all_gather(self._encode(batch, eps), 0)
        if self.latent_space_type == "vae":
            self.scale_factor = float(1.0 / (z.std(correction=0) + 1e-8))
        elif self.vae is None:
            self.scale_factor = float(1.0 / z.std())
        self.latent_shape = tuple(z.shape)
        return self.scale_factor, self.latent_shape

    # ------------------------------------------------------------------ steps

    noise_shape = latent_shape_of

    def _clean(self, imgs, draws):
        eps = None if draws.eps is None else draws.eps.to(self.device)
        return self._scale(self._encode(imgs, eps)).float()

    # ---------------------------------------------------------------- sampling

    def sample_images(self, n_samples: int, sampler: str = "ddim",
                      num_inference_steps: Optional[int] = None,
                      generator: Optional[torch.Generator] = None) -> np.ndarray:
        """``n_samples`` decoded images (n, *spatial, C) in [0, 1] through
        ``LDMSampler`` with the sampling weights."""
        if self.latent_shape is None:
            raise RuntimeError("call probe_latent first: sampling needs the latent shape")
        if self.vae is None:
            raise NotImplementedError("sampling decodes through the autoencoder: a trainer "
                                      "on precomputed latents has none")
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
        ``latent_shape``; every tensor copied to the CPU. ``save_checkpoint``
        writes it as the ``.pt`` that ``training.sample.load_torch_checkpoint``
        reads (``medimgen_torch_sample_ldm`` samples ``unet``, as the JAX
        sampling CLI samples ``params``)."""
        if self.latent_shape is None:
            raise RuntimeError("call probe_latent first: the checkpoint needs the latent shape")
        out = super()._host_state()
        out[self.latent_space_type] = {k: v.cpu() for k, v in self.vae.state_dict().items()}
        out.update(scale_factor=float(self.scale_factor),
                   latent_shape=[int(v) for v in self.latent_shape])
        return out

    @torch.no_grad()
    def load_payload(self, payload: Dict) -> None:
        """The shared state, and the scale factor."""
        super().load_payload(payload)
        self.scale_factor = float(payload["scale_factor"])

    # -------------------------------------------------------------- main loop

    def _prepare(self, train_loader) -> None:
        first = common.batch_to_device(next(iter(train_loader)), self.device)[0]
        scale, shape = self.probe_latent(first)
        print(f"Scaling factor set to {scale}")
        print(f"Latent shape: {shape}")

    def _after_samples(self, val_loader, stats) -> None:
        if self.config.get("run_generation_eval", self.spatial_dims == 2):
            t = time.perf_counter()
            stats["eval"] = self.evaluate_generation(val_loader)
            stats["eval_s"] = time.perf_counter() - t


# --------------------------------------------------------------------- CLI

def parse_arguments(argv: Optional[Sequence[str]] = None):
    parser = common.train_cli_parser("Train a Latent Diffusion Model (PyTorch port).")
    parser.add_argument("-l", "--latent_space_type", default="vae", choices=["vae", "vq"])
    return common.parse_train_args(parser, argv)


def run_cli(argv: Optional[Sequence[str]] = None) -> LDMTrainer:
    """``medimgen_torch_train_ldm``: the JAX ``main`` (train_ldm.py:
    585-627) on the port; returns the trainer after training. Everything
    the port cannot do is refused here, before the first step."""
    args = parse_arguments(argv)
    device = maybe_initialize_distributed(args.device) or resolve_device(args.device)
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
    mesh = get_mesh(model_parallel=int(config.get("model_parallel", 1)), device=device)
    train_loader, val_loader = get_data_loaders(
        config, args.dataset_id, args.splitting, config["ddpm_batch_size"],
        args.model_type, config["ddpm_transformations"], args.fold,
        data_parallel=mesh.shape["data"], mesh=mesh,
    )
    trainer = LDMTrainer.from_config(config, ae[key], device=device,
                                     dtype=common.DTYPES[args.dtype], seed=0,
                                     steps_per_epoch=len(train_loader),
                                     latent_space_type=key, mesh=mesh)
    del ae
    trainer.train(train_loader, val_loader)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    run_cli(argv)


if __name__ == "__main__":
    main()
