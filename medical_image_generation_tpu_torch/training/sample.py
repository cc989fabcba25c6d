"""LDM sampling: ``LDMSampler`` and the ``medimgen_torch_sample_ldm`` CLI.

``LDMSampler.sample`` is the counterpart of ``LDMTrainer.sample_images``
(``medical_image_generation_tpu/training/train_ldm.py:289-354``): a DDIM or
ancestral DDPM trajectory in the latent space, classifier-free guidance
``e_u + g * (e_c - e_u)`` for class-conditional models, then the latent
divided by the VAE ``scale_factor``, decoded, and clipped to [0, 1].
Images come out in the JAX layout (B, *spatial, C) as numpy arrays.

The CLI reads a torch checkpoint (``.pt`` holding ``unet`` and ``vae``
state_dicts, ``scale_factor`` and ``latent_shape``) plus the run's
config.yaml, and writes one ``.npy`` volume per sample. Reading the JAX
package's orbax checkpoints needs JAX and is not part of the port yet.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from medical_image_generation_tpu_torch._device import resolve_device
from medical_image_generation_tpu_torch.config.run import load_config
from medical_image_generation_tpu_torch.diffusion.sampler import DDIMSampler, SegmentedDDPMSampler
from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class LDMSampler:
    """Samples images from a latent diffusion model (U-Net + KL-VAE decoder).

    ``num_classes`` (class-conditional models): the U-Net has
    ``num_classes + 1`` class embeddings, the last one the null class used
    for guidance."""

    def __init__(self, unet: DiffusionUNet, vae: AutoencoderKL, schedule: NoiseSchedule,
                 scale_factor: float, latent_shape: Sequence[int],
                 num_classes: Optional[int] = None, guidance_scale: float = 2.0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.unet = unet.eval()
        self.vae = vae.eval()
        self.schedule = schedule
        self.scale_factor = float(scale_factor)
        self.latent_shape = tuple(int(v) for v in latent_shape)
        self.num_classes = num_classes
        self.guidance_scale = float(guidance_scale)

    @staticmethod
    def from_config(config: dict, unet_state, vae_state, scale_factor: float,
                    latent_shape: Sequence[int], dtype=torch.bfloat16,
                    device: str | torch.device = "cuda") -> "LDMSampler":
        """Build the networks from a run config (``vae_params``,
        ``ddpm_params``, ``time_scheduler_params``, optional
        ``class_conditioning``) and load their state_dicts; ``vae_state`` may
        be the whole KL-VAE or its decoding half (only that half is built)."""
        dev = resolve_device(device)
        ddpm_params = dict(config["ddpm_params"])
        cc = config.get("class_conditioning") or None
        num_classes = None
        if cc:
            num_classes = int(cc["num_classes"])
            ddpm_params["num_class_embeds"] = num_classes + 1
        unet = DiffusionUNet.from_config(ddpm_params, dtype=dtype, device=dev)
        vae = AutoencoderKL.from_config(config["vae_params"], dtype=dtype, device=dev,
                                        with_encoder=False)
        unet.load_state_dict(unet_state)
        vae.load_state_dict({k: v for k, v in vae_state.items()
                             if k.startswith(("post_quant_conv.", "decoder."))})
        schedule = NoiseSchedule.from_config(config["time_scheduler_params"], device=dev)
        return LDMSampler(unet, vae, schedule, scale_factor, latent_shape, num_classes,
                          float((cc or {}).get("guidance_scale", 2.0)), dev)

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
        """Latent (scaled, as the U-Net sees it) -> image in [0, 1]."""
        return self.vae.decode(z / self.scale_factor).clamp(0.0, 1.0)

    @torch.no_grad()
    def sample(self, n_samples: int, sampler: str = "ddpm",
               num_inference_steps: Optional[int] = None, class_label=None,
               guidance_scale: Optional[float] = None,
               generator: Optional[torch.Generator] = None,
               x_T: Optional[torch.Tensor] = None,
               noises: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
        """Generate ``n_samples`` decoded images, (n, *spatial, C) in [0, 1].
        ``x_T`` / ``noises`` replace the generator's draws when given."""
        shape = (n_samples,) + self.latent_shape[1:]
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


def load_torch_checkpoint(path: str) -> dict:
    """A ``.pt`` payload: {"unet": state_dict, "vae": state_dict,
    "scale_factor": float, "latent_shape": [..]}."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    missing = {"unet", "vae", "scale_factor", "latent_shape"} - set(payload)
    if missing:
        raise KeyError(f"checkpoint {path} lacks {sorted(missing)}")
    return payload


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sample volumes from a trained LDM (PyTorch port).")
    p.add_argument("config", help="run config.yaml (vae_params, ddpm_params, ...)")
    p.add_argument("checkpoint", help=".pt with unet/vae state_dicts, scale_factor, latent_shape")
    p.add_argument("-n", "--n_samples", type=int, default=4)
    p.add_argument("-o", "--output_dir", default="samples")
    p.add_argument("-s", "--sampler", choices=["ddpm", "ddim"], default="ddim")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--class_label", type=int, default=None)
    p.add_argument("--guidance_scale", type=float, default=None)
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16")
    p.add_argument("--device", default="cuda")
    return p


def main_ldm(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    payload = load_torch_checkpoint(args.checkpoint)
    sampler = LDMSampler.from_config(
        load_config(args.config), payload["unet"], payload["vae"], payload["scale_factor"],
        payload["latent_shape"], dtype=_DTYPES[args.dtype], device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    images = sampler.sample(args.n_samples, sampler=args.sampler,
                            num_inference_steps=args.num_inference_steps,
                            class_label=args.class_label, guidance_scale=args.guidance_scale,
                            generator=gen)
    os.makedirs(args.output_dir, exist_ok=True)
    for i, img in enumerate(images):
        np.save(os.path.join(args.output_dir, f"ldm_sample_{i:03d}.npy"), img)
    print(f"Wrote {len(images)} samples of shape {images.shape[1:]} to {args.output_dir}")


if __name__ == "__main__":
    main_ldm()
