"""Pixel-space DDPM training: ``DDPMTrainer`` and the ``medimgen_torch_train_ddpm`` CLI.

Port of ``DDPMTrainer`` (``medical_image_generation_tpu/training/
train_ddpm.py:55-364``) and its CLI (:367-405): the diffusion U-Net trained
straight on image patches, with in and out channels equal to the data's
(``len(input_channels)``, JAX :66-70) and the planner's
``ddpm_time_scheduler_params``, which ``filter_config_by_mode(config,
"train_ddpm")`` swaps into ``time_scheduler_params`` before the CLI's
``--set`` overrides (so a user's ``--set time_scheduler_params.*`` wins, as
in JAX :393-397).

The step, the loop, the payload and the resume are
``common.DiffusionTrainer``'s, shared with the LDM. One ``train_step`` runs
(JAX ``_make_train_step``, :138-170): device augmentation of the loader's
patch, cropped to ``patch_size``; ``t`` uniform in [0, T), image-shaped
noise, ``add_noise`` and the training target on the fp32 images; optional
classifier-free label dropout (:134-136); the U-Net forward in the compute
dtype with fp32 master params, ``mean((pred.f32 - target)^2)``, backward;
clip + AdamW with a bf16 first moment, in ``MultiSteps`` when
``grad_accumulate_step > 1``; the EMA on synced steps. ``TrainDraws``
carries its draws with no posterior ``eps``. ``val_step`` (:172-191) has no
augmentation and no dropout and passes the labels through.

``sample_images`` (:193-250) samples the EMA weights when EMA is on, with
``ddpm`` (the full ancestral trajectory, the JAX default) or ``ddim``, CFG
with the null class, clipped to [0, 1] (``training.sample.PixelSampler``).
Every ``val_plot_interval`` epochs the loop writes 16 DDIM samples as a PNG
grid in 2D, or one volume as a GIF in 3D (``.npy`` without PIL), as
``plots.save_samples`` does for the LDM. The loss keys are ``rec_loss`` /
``val_rec_loss``. A last/best payload (JAX :317-333) holds ``epoch``,
``unet``, ``ema_unet`` (with EMA), ``opt_state``, ``step``,
``validation_loss``, the generators' and the train loader's states; no
autoencoder and no ``scale_factor``. ``best_val`` comes from the last
checkpoint on resume, as JAX :358 sets it; unlike JAX, whose loop restarts
its step counter at 0 (:266) and so replays the first epoch's keys, a
resumed run continues its draws and its patient order bit for bit.

``use_checkpointing`` in ``ddpm_params`` rematerialises every U-Net
ResBlock (``models/diffusion_unet.py``), as the JAX U-Net's ``nn.remat``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from medical_image_generation_tpu_torch._device import resolve_device
from medical_image_generation_tpu_torch.config.run import (
    apply_overrides,
    filter_config_by_mode,
    get_config_for_current_task,
    print_configuration,
)
from medical_image_generation_tpu_torch.data.loader import get_data_loaders
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    maybe_initialize_distributed,
)
from medical_image_generation_tpu_torch.training import common
from medical_image_generation_tpu_torch.training.sample import (
    PixelSampler,
    ddpm_image_shape,
    ddpm_unet_params,
)


class DDPMTrainer(common.DiffusionTrainer):
    """Pixel-space diffusion trainer. Build with ``from_config``."""

    def __init__(self, config: dict, unet: DiffusionUNet, device: str | torch.device = "cuda",
                 seed: int = 0, steps_per_epoch: int = 250, mesh: Optional[Mesh] = None):
        super().__init__(config, unet, config["ddpm_params"]["spatial_dims"], device, seed,
                         steps_per_epoch, mesh)
        self.image_shape = ddpm_image_shape(config)
        cc = self.class_cond or {}
        self.guidance_scale = float(cc.get("guidance_scale", 2.0))

    @staticmethod
    def from_config(config: dict, unet_state=None, device: str | torch.device = "cuda",
                    dtype=torch.bfloat16, seed: int = 0, steps_per_epoch: int = 250,
                    mesh: Optional[Mesh] = None) -> "DDPMTrainer":
        """U-Net with fp32 master params computing in ``dtype``, in and out
        channels the data's (and the null class's embedding with
        ``class_conditioning``); flax-style initialisation from ``seed``, or
        ``unet_state``."""
        dev = resolve_device(device)
        params, _ = ddpm_unet_params(config)
        torch.manual_seed(seed)
        unet = DiffusionUNet.from_config(params, dtype=dtype, param_dtype=torch.float32,
                                         device=dev)
        if unet_state is None:
            common.init_like_flax_(unet)
        else:
            unet.load_state_dict(unet_state)
        return DDPMTrainer(config, unet, dev, seed, steps_per_epoch, mesh)

    def noise_shape(self, batch):
        """(B, *patch, C): the images the U-Net sees."""
        return (batch.shape[0], *self._final_spatial(batch), batch.shape[-1])

    def _clean(self, imgs, draws):
        return imgs.float()

    def sample_images(self, n_samples: int, sampler: str = "ddpm",
                      num_inference_steps: Optional[int] = None, class_label=None,
                      guidance_scale: Optional[float] = None,
                      generator: Optional[torch.Generator] = None,
                      x_T: Optional[torch.Tensor] = None,
                      noises: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
        """``n_samples`` images (n, *patch, C) in [0, 1] from the sampling
        weights; class-conditional models sample the null class, or
        ``class_label`` with guidance."""
        with self.sampling_weights() as unet:
            return PixelSampler(unet, self.schedule, self.image_shape,
                                self.num_classes if self.class_cond else None,
                                self.guidance_scale, self.device).sample(
                n_samples, sampler=sampler, num_inference_steps=num_inference_steps,
                class_label=class_label, guidance_scale=guidance_scale, generator=generator,
                x_T=x_T, noises=noises)


# --------------------------------------------------------------------- CLI

def parse_arguments(argv: Optional[Sequence[str]] = None):
    return common.parse_train_args(
        common.train_cli_parser("Train a pixel-space DDPM (PyTorch port)."), argv)


def run_cli(argv: Optional[Sequence[str]] = None) -> DDPMTrainer:
    """``medimgen_torch_train_ddpm``: the JAX ``main`` (train_ddpm.py:
    385-405) on the port; returns the trainer after training. What the port
    cannot do is refused before the first step."""
    args = parse_arguments(argv)
    device = maybe_initialize_distributed(args.device) or resolve_device(args.device)
    config = get_config_for_current_task(
        args.dataset_id, args.model_type, "ddpm",
        progress_bar=args.progress_bar, continue_training=args.continue_training,
    )
    # filter BEFORE overrides: the swap of ddpm_time_scheduler_params into
    # time_scheduler_params must not undo a user's --set time_scheduler_params.*
    config = filter_config_by_mode(config, "train_ddpm")
    config = apply_overrides(config, args.overrides)
    print_configuration(config, config["results_path"], "train", model="ddpm")
    mesh = get_mesh(model_parallel=int(config.get("model_parallel", 1)), device=device)
    train_loader, val_loader = get_data_loaders(
        config, args.dataset_id, args.splitting, config["ddpm_batch_size"],
        args.model_type, config["ddpm_transformations"], args.fold,
        data_parallel=mesh.shape["data"], mesh=mesh,
    )
    trainer = DDPMTrainer.from_config(config, device=device, dtype=common.DTYPES[args.dtype],
                                      seed=0, steps_per_epoch=len(train_loader), mesh=mesh)
    trainer.train(train_loader, val_loader)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    run_cli(argv)


if __name__ == "__main__":
    main()
