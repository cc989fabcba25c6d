"""LDM sampling: ``LDMSampler`` and the ``medimgen_torch_sample_ldm`` CLI.

``LDMSampler.sample`` is the counterpart of ``LDMTrainer.sample_images``
(``medical_image_generation_tpu/training/train_ldm.py:289-354``): a DDIM or
ancestral DDPM trajectory in the latent space, classifier-free guidance
``e_u + g * (e_c - e_u)`` for class-conditional models, then the latent
unscaled (divided by the KL-VAE ``scale_factor``, or mapped from [-1, 1]
back to the VQ codebook's [min, max], JAX ``_unscale`` :152-155), decoded
(the VQ-VAE quantizes first: ``decode_stage_2_outputs``), and clipped to
[0, 1]. Images come out in the JAX layout (B, *spatial, C) as numpy arrays.

The CLI reads a torch checkpoint (``.pt`` holding ``unet`` and ``vae`` (or
``vq``) state_dicts, ``scale_factor`` and ``latent_shape``) plus the run's
config.yaml (its ``latent_space_type`` picks the autoencoder), and writes
what the JAX ``_write_outputs`` writes (``training/sample.py:57-73``): in 3D
one ``ldm_sample_NNN.nii.gz`` a sample, float32 in NIfTI (X, Y, Z[, C])
order (``io/nifti.py``); in 2D one ``ldm_sample_NNN.png`` a sample and
``ldm_sample_grid.png`` (``io/png.py``). It samples ``unet``,
the live params, as the JAX sampling CLI samples ``params``
(``training/sample.py:89-95``); a checkpoint of a run with EMA also holds
``ema_unet``, which the training loop's interval samples use. The
trainer's ``save_checkpoint`` and its last/best payloads are such files, and
``tools/orbax_to_torch.py`` (run with the JAX package) writes one from a JAX
orbax checkpoint.

``PixelSampler`` is the pixel-space DDPM's counterpart of
``DDPMTrainer.sample_images`` (JAX ``training/train_ddpm.py:193-250``): the
same trajectories and guidance straight in image space, clipped to [0, 1]
(``LDMSampler`` is a ``PixelSampler`` that decodes its latent first). The
``medimgen_torch_sample_ddpm`` CLI (``main_ddpm``, JAX ``training/sample.py:
101-121``) reads the run's config.yaml and a ``.pt`` holding ``unet``
(``load_ddpm_checkpoint``: a DDPM payload has no autoencoder), samples the
live params as the JAX CLI does, at the shape of
``ddpm_transformations.patch_size`` (JAX ``:92``), and writes
``ddpm_sample_NNN.nii.gz`` or ``.png`` files and ``ddpm_sample_grid.png``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from medical_image_generation_tpu_torch._device import resolve_device
from medical_image_generation_tpu_torch.config.run import load_config
from medical_image_generation_tpu_torch.diffusion.sampler import DDIMSampler, SegmentedDDPMSampler
from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule
from medical_image_generation_tpu_torch.io import png
from medical_image_generation_tpu_torch.io.nifti import save_nifti
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.parallel.mesh import maybe_initialize_distributed
from medical_image_generation_tpu_torch.training.common import DTYPES, build_generator


class PixelSampler:
    """Samples images from a diffusion U-Net in image space: DDIM or the
    ancestral DDPM trajectory, classifier-free guidance ``e_u + g * (e_c -
    e_u)`` for class-conditional models, then ``decode`` (here a clip to
    [0, 1]). ``sample_shape``: one sample's (*spatial, C).

    ``num_classes`` (class-conditional models): the U-Net has
    ``num_classes + 1`` class embeddings, the last one the null class used
    for guidance."""

    def __init__(self, unet: DiffusionUNet, schedule: NoiseSchedule, sample_shape: Sequence[int],
                 num_classes: Optional[int] = None, guidance_scale: float = 2.0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.unet = unet.eval()
        self.schedule = schedule
        self.sample_shape = tuple(int(v) for v in sample_shape)
        self.num_classes = num_classes
        self.guidance_scale = float(guidance_scale)

    @staticmethod
    def from_config(config: dict, unet_state, dtype=torch.bfloat16,
                    device: str | torch.device = "cuda") -> "PixelSampler":
        """The pixel-space DDPM of a run config (``ddpm_params`` with in and
        out channels ``len(input_channels)``, ``time_scheduler_params``,
        ``ddpm_transformations.patch_size``, optional ``class_conditioning``)
        with ``unet_state`` loaded."""
        dev = resolve_device(device)
        ddpm_params, num_classes = ddpm_unet_params(config)
        unet = DiffusionUNet.from_config(ddpm_params, dtype=dtype, device=dev)
        unet.load_state_dict(unet_state)
        schedule = NoiseSchedule.from_config(config["time_scheduler_params"], device=dev)
        cc = config.get("class_conditioning") or {}
        return PixelSampler(unet, schedule, ddpm_image_shape(config), num_classes,
                            float(cc.get("guidance_scale", 2.0)), dev)

    def _model_fn(self, labels, g: float):
        def fn(x, t):
            if labels is None:
                return self.unet(x, t)
            e_c = self.unet(x, t, class_labels=labels)
            if g == 1.0:
                return e_c
            e_u = self.unet(x, t, class_labels=torch.full_like(labels, self.num_classes))
            return e_u + g * (e_c - e_u)
        return fn

    @torch.no_grad()
    def decode(self, z) -> torch.Tensor:
        """The trajectory's end -> image in [0, 1]."""
        return z.clamp(0.0, 1.0)

    @torch.no_grad()
    def sample(self, n_samples: int, sampler: str = "ddpm",
               num_inference_steps: Optional[int] = None, class_label=None,
               guidance_scale: Optional[float] = None,
               generator: Optional[torch.Generator] = None,
               x_T: Optional[torch.Tensor] = None,
               noises: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
        """Generate ``n_samples`` images, (n, *spatial, C) in [0, 1].
        ``x_T`` / ``noises`` replace the generator's draws when given."""
        shape = (n_samples,) + self.sample_shape
        labels, g = None, 1.0
        if self.num_classes is not None:
            if class_label is None:
                labels = torch.full((n_samples,), self.num_classes, dtype=torch.long,
                                    device=self.device)
            else:
                labels = torch.as_tensor(
                    np.broadcast_to(np.asarray(class_label, np.int64), (n_samples,)).copy(),
                    device=self.device)
                g = float(self.guidance_scale if guidance_scale is None else guidance_scale)
        if sampler == "ddim":
            traj = DDIMSampler(self.schedule, num_inference_steps or 50)
        elif sampler == "ddpm":
            traj = SegmentedDDPMSampler(self.schedule)
        else:
            raise ValueError(f"unknown sampler {sampler!r}")
        z = traj(self._model_fn(labels, g), shape, device=self.device, generator=generator,
                 x_T=x_T, noises=noises)
        return self.decode(z).cpu().numpy()


def ddpm_unet_params(config: dict):
    """(ddpm_params, num_classes or None) of the pixel-space DDPM (JAX
    ``train_ddpm.py:66-76``): in and out channels follow the data, and a
    class-conditional run adds the null class's embedding."""
    params = dict(config["ddpm_params"])
    n_ch = len(config.get("input_channels", [0]))
    params["in_channels"] = params["out_channels"] = n_ch
    cc = config.get("class_conditioning") or None
    num_classes = None
    if cc:
        num_classes = int(cc["num_classes"])
        params["num_class_embeds"] = num_classes + 1
    return params, num_classes


def ddpm_image_shape(config: dict):
    """One pixel-space sample's (*spatial, C): ``ddpm_transformations.
    patch_size`` (its last two axes in 2D) and the data's channels (JAX
    ``train_ddpm.py:84-87``)."""
    patch = tuple(config["ddpm_transformations"]["patch_size"])
    if config["ddpm_params"]["spatial_dims"] == 2 and len(patch) == 3:
        patch = patch[-2:]
    return patch + (len(config.get("input_channels", [0])),)


class LDMSampler(PixelSampler):
    """Samples images from a latent diffusion model (U-Net + the decoding
    half of a KL-VAE, or of a VQ-VAE with ``latent_space_type="vq"``): a
    ``PixelSampler`` over the latent whose ``decode`` unscales and decodes."""

    def __init__(self, unet: DiffusionUNet, vae, schedule: NoiseSchedule,
                 scale_factor: float, latent_shape: Sequence[int],
                 num_classes: Optional[int] = None, guidance_scale: float = 2.0,
                 device: str | torch.device = "cuda", latent_space_type: str = "vae"):
        super().__init__(unet, schedule, tuple(latent_shape)[1:], num_classes, guidance_scale,
                         device)
        self.vae = vae.eval()
        self.latent_space_type = latent_space_type
        if latent_space_type == "vq":
            codebook = self.vae.quantizer.codebook.detach()
            self.codebook_min = float(codebook.min())
            self.codebook_max = float(codebook.max())
        self.scale_factor = float(scale_factor)
        self.latent_shape = tuple(int(v) for v in latent_shape)

    @staticmethod
    def from_config(config: dict, unet_state, vae_state, scale_factor: float,
                    latent_shape: Sequence[int], dtype=torch.bfloat16,
                    device: str | torch.device = "cuda") -> "LDMSampler":
        """Build the networks from a run config (``vae_params`` (or
        ``vqvae_params``), ``ddpm_params``, ``time_scheduler_params``,
        optional ``class_conditioning`` and ``latent_space_type``) and load
        their state_dicts; ``vae_state`` may be the whole autoencoder or its
        decoding half (only that half is built)."""
        dev = resolve_device(device)
        latent = config.get("latent_space_type", "vae")
        ddpm_params = dict(config["ddpm_params"])
        cc = config.get("class_conditioning") or None
        num_classes = None
        if cc:
            num_classes = int(cc["num_classes"])
            ddpm_params["num_class_embeds"] = num_classes + 1
        unet = DiffusionUNet.from_config(ddpm_params, dtype=dtype, device=dev)
        vae = build_generator(config, latent, dtype, device=dev, with_encoder=False)
        unet.load_state_dict(unet_state)
        vae.load_state_dict({k: v for k, v in vae_state.items()
                             if k.startswith(("post_quant_conv.", "decoder.", "quantizer."))})
        schedule = NoiseSchedule.from_config(config["time_scheduler_params"], device=dev)
        return LDMSampler(unet, vae, schedule, scale_factor, latent_shape, num_classes,
                          float((cc or {}).get("guidance_scale", 2.0)), dev, latent)

    @torch.no_grad()
    def decode(self, z) -> torch.Tensor:
        """Latent (scaled, as the U-Net sees it) -> image in [0, 1]."""
        if self.latent_space_type == "vae":
            return self.vae.decode(z / self.scale_factor).clamp(0.0, 1.0)
        lo, hi = self.codebook_min, self.codebook_max
        return self.vae.decode_stage_2_outputs((z + 1) / 2 * (hi - lo) + lo).clamp(0.0, 1.0)


def load_torch_checkpoint(path: str) -> dict:
    """A ``.pt`` payload: {"unet": state_dict, "vae" or "vq": state_dict,
    "scale_factor": float, "latent_shape": [..]}."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    missing = {"unet", "scale_factor", "latent_shape"} - set(payload)
    if not {"vae", "vq"} & set(payload):
        missing.add("vae")
    if missing:
        raise KeyError(f"checkpoint {path} lacks {sorted(missing)}")
    return payload


def load_ddpm_checkpoint(path: str) -> dict:
    """A pixel-space DDPM ``.pt`` payload: {"unet": state_dict, ...} (a
    last/best payload of ``DDPMTrainer``, or its ``save_checkpoint``)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "unet" not in payload:
        raise KeyError(f"checkpoint {path} lacks ['unet']")
    return payload


def _parser(model: str = "LDM",
            checkpoint_help: str = ".pt with unet/vae state_dicts, scale_factor, latent_shape",
            ) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=f"Sample images or volumes from a trained {model} (PyTorch port).")
    p.add_argument("config", help="run config.yaml (ddpm_params, time_scheduler_params, ...)")
    p.add_argument("checkpoint", help=checkpoint_help)
    p.add_argument("-n", "--n_samples", type=int, default=4)
    p.add_argument("-o", "--output_dir", default="samples")
    p.add_argument("-s", "--sampler", choices=["ddpm", "ddim"], default="ddim")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--class_label", type=int, default=None)
    p.add_argument("--guidance_scale", type=float, default=None)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda")
    return p


def rank0_device(name: str) -> Optional[torch.device]:
    """The sampling CLIs' device: under torchrun, rank 0's card (the other
    ranks sample nothing and get None); else ``name``."""
    dev = maybe_initialize_distributed(name)
    if dev is not None and dist.get_rank() != 0:
        print(f"rank {dist.get_rank()}: sampling runs on rank 0")
        return None
    return dev or resolve_device(name)


def main_ldm(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    device = rank0_device(args.device)
    if device is None:
        return
    payload = load_torch_checkpoint(args.checkpoint)
    config = load_config(args.config)
    key = config.get("latent_space_type", "vae")
    if key not in payload:
        raise KeyError(f"{args.checkpoint} holds no {key!r} autoencoder, which the config's "
                       f"latent_space_type asks for")
    sampler = LDMSampler.from_config(
        config, payload["unet"], payload[key], payload["scale_factor"],
        payload["latent_shape"], dtype=DTYPES[args.dtype], device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    images = sampler.sample(args.n_samples, sampler=args.sampler,
                            num_inference_steps=args.num_inference_steps,
                            class_label=args.class_label, guidance_scale=args.guidance_scale,
                            generator=gen)
    _write_outputs(images, args.output_dir, "ldm_sample")


def main_ddpm(argv: Optional[Sequence[str]] = None) -> None:
    """``medimgen_torch_sample_ddpm``: samples the checkpoint's ``unet`` (the
    live params, as the JAX CLI samples ``params``) at the shape of the
    config's ``ddpm_transformations.patch_size``."""
    args = _parser("pixel-space DDPM", ".pt holding the unet state_dict").parse_args(argv)
    device = rank0_device(args.device)
    if device is None:
        return
    payload = load_ddpm_checkpoint(args.checkpoint)
    sampler = PixelSampler.from_config(load_config(args.config), payload["unet"],
                                       dtype=DTYPES[args.dtype], device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    images = sampler.sample(args.n_samples, sampler=args.sampler,
                            num_inference_steps=args.num_inference_steps,
                            class_label=args.class_label, guidance_scale=args.guidance_scale,
                            generator=gen)
    _write_outputs(images, args.output_dir, "ddpm_sample")


def _write_outputs(images: np.ndarray, output_dir: str, tag: str) -> None:
    """Samples (n, *spatial, C) as files: ``{tag}_NNN.nii.gz`` in NIfTI
    (X, Y, Z[, C]) order for volumes; ``{tag}_NNN.png`` and ``{tag}_grid.png``
    for 2D images (JAX ``training/sample.py:57-73``)."""
    os.makedirs(output_dir, exist_ok=True)
    volumes = images.ndim == 5
    for i, img in enumerate(images):
        if volumes:
            vol = np.squeeze(img, axis=-1) if img.shape[-1] == 1 else img
            # (Z, Y, X[, C]) -> NIfTI (X, Y, Z[, C]): the spatial axes reverse
            vol = np.transpose(vol, (2, 1, 0, 3) if vol.ndim == 4 else (2, 1, 0))
            save_nifti(os.path.join(output_dir, f"{tag}_{i:03d}.nii.gz"), vol.astype(np.float32))
        else:
            png.write_png(os.path.join(output_dir, f"{tag}_{i:03d}.png"), png.to_uint8(img))
    if not volumes:
        png.write_png(os.path.join(output_dir, f"{tag}_grid.png"), png.image_grid(list(images)))
    print(f"Wrote {len(images)} samples of shape {images.shape[1:]} to {output_dir}")


if __name__ == "__main__":
    main_ldm()
