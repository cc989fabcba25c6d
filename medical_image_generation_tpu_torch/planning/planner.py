"""Planner math for model configs: the port's own copy.

Copied from ``medical_image_generation_tpu/planning/planner.py`` (the
numpy-free functions at :28-295) so the port builds planner configs without
importing the JAX package. Same semantics: the nnU-Net-style per-axis
stride/kernel/padding derivation, the KL-VAE / diffusion U-Net architecture
dicts derived from a dataset's median shape, and the full training config
(``create_config_dict``: augmentation switches, learning rates, noise
schedule).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

VALID_2D_SIZES = [32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384, 448, 512]
VALID_3D_SIZES = [32, 48, 56, 64, 96, 112, 128, 192, 224, 256, 384, 448, 512]


def compute_downsample_parameters(
    input_size: Sequence[int], num_layers: int
) -> List[List[List[int]]]:
    """Per-layer, per-axis [stride, kernel, padding]. Layer 0 never
    downsamples; an axis whose extent is <= 0.5x the largest other axis gets
    kernel 1 / stride 1 so anisotropic volumes keep their thin axis."""
    ndim = len(input_size)
    size = list(input_size)
    params: List[List[List[int]]] = []
    for layer in range(num_layers):
        stride = [1] * ndim
        kernel = [3] * ndim
        padding = [1] * ndim
        for d in range(ndim):
            others = [size[j] for j in range(ndim) if j != d]
            thin = size[d] <= 0.5 * max(others, default=size[d])
            if layer == 0:
                if thin:
                    kernel[d] = 1
                    padding[d] = 0
            elif thin:
                stride[d], kernel[d], padding[d] = 1, 1, 0
            else:
                stride[d], kernel[d], padding[d] = 2, 3, 1
        if layer > 0:
            for d in range(ndim):
                size[d] = (size[d] + 2 * padding[d] - kernel[d]) // stride[d] + 1
        params.append([stride, kernel, padding])
    return params


def compute_output_size(
    input_size: Sequence[int], downsample_parameters: Sequence[Sequence[Sequence[int]]]
) -> List[int]:
    """Spatial size after every (stride, kernel, padding) layer."""
    out = list(input_size)
    for stride, kernel, padding in downsample_parameters:
        for d in range(len(out)):
            out[d] = (out[d] + 2 * padding[d] - kernel[d]) // stride[d] + 1
    return out


def snap_patch_size(
    median_shape: Sequence[int], max_shape: Sequence[int], spatial_dims: int
) -> List[int]:
    """Snap the dataset's shape statistics to the valid size ladder (2D:
    max shape without its first axis; 3D: median shape)."""
    if spatial_dims == 2:
        snapped = [min(VALID_2D_SIZES, key=lambda v: abs(v - s)) for s in max_shape]
        return snapped[1:]
    return [min(VALID_3D_SIZES, key=lambda v: abs(v - s)) for s in median_shape]


def _n_downsample_layers(patch_size: Sequence[int]) -> int:
    m = max(patch_size)
    if m <= 96:
        return 1
    if m <= 384:
        return 2
    return 3


def create_autoencoder_dict(
    dataset_config: Dict, input_channels: Sequence[int], spatial_dims: int
) -> Dict:
    """KL-VAE architecture derived from the dataset fingerprint."""
    patch_size = snap_patch_size(
        dataset_config["median_shape"], dataset_config["max_shape"], spatial_dims
    )
    base_channels = [64, 128, 256, 256] if spatial_dims == 2 else [32, 64, 128, 128]
    n_layers = _n_downsample_layers(patch_size)
    down = compute_downsample_parameters(patch_size, n_layers + 1)
    return {
        "spatial_dims": spatial_dims,
        "in_channels": len(input_channels),
        "out_channels": len(input_channels),
        "latent_channels": 8,
        "num_res_blocks": 2,
        "with_encoder_nonlocal_attn": False,
        "with_decoder_nonlocal_attn": False,
        "use_flash_attention": True,
        "use_checkpointing": False,
        "use_convtranspose": False,
        "num_channels": base_channels[: n_layers + 1],
        "attention_levels": [False] * (n_layers + 1),
        "norm_num_groups": 16,
        "downsample_parameters": down,
        "upsample_parameters": list(reversed(down))[:-1],
    }


def create_ddpm_dict(dataset_config: Dict, spatial_dims: int) -> Dict:
    """Diffusion U-Net architecture over the autoencoder's latent grid."""
    patch_size = snap_patch_size(
        dataset_config["median_shape"], dataset_config["max_shape"], spatial_dims
    )
    n_layers = _n_downsample_layers(patch_size)
    vae_down = compute_downsample_parameters(patch_size, n_layers + 1)
    latent_size = compute_output_size(patch_size, vae_down)
    ddpm_down = compute_downsample_parameters(latent_size, 3)
    return {
        "spatial_dims": spatial_dims,
        "in_channels": 8,
        "out_channels": 8,
        "num_res_blocks": 2,
        "use_flash_attention": True,
        "num_channels": [256, 512, 768],
        "attention_levels": [False, True, True],
        "num_head_channels": [0, 512, 768],
        "strides": [p[0] for p in ddpm_down],
        "kernel_sizes": [p[1] for p in ddpm_down],
        "paddings": [p[2] for p in ddpm_down],
    }


def create_config_dict(
    dataset_config: Dict,
    input_channels: Sequence[int],
    n_epochs_multiplier: int,
    autoencoder_dict: Dict,
    ddpm_dict: Dict,
) -> Dict:
    """Full derived training config (reference configuration.py:907-1027).

    Loss weights, learning rates, epoch counts, noise schedule, and the soft
    augmentation switch set are reproduced verbatim so training dynamics match.
    """
    spatial_dims = autoencoder_dict["spatial_dims"]
    patch_size = snap_patch_size(
        dataset_config["median_shape"], dataset_config["max_shape"], spatial_dims
    )
    batch_size = 24 if spatial_dims == 2 else 2

    ae_transformations = {
        "patch_size": patch_size,
        "scaling": True,
        "rotation": True,
        "gaussian_noise": False,
        "gaussian_blur": False,
        "low_resolution": False,
        "brightness": True,
        "contrast": True,
        "gamma": True,
        "mirror": True,
        "dummy_2d": False,
        "elastic": False,  # reference CLI switch (configuration.py:70), off by default
        # "soft" = the reference's image-generation branch
        # (data_processing.py:400-416); "nnunet" = its heavy nnU-Net branch
        # (:371-397) with anisotropy-aware 3D rotation and wider ranges
        "aug_preset": "soft",
        # extract a rotation/scale-enlarged training patch and crop back to
        # patch_size AFTER the device spatial transform, so rotated/zoomed
        # samples have no zero-filled corners (nnU-Net get_initial_patch_size,
        # reference data_processing.py:339-359). Emitted true for new plans;
        # configs without the key keep the reference soft-branch behavior
        # (final-size patch, zero corners under rotation).
        "initial_patch_enlargement": True,
    }
    ddpm_transformations = dict(ae_transformations, rotation=False)

    if spatial_dims == 2:
        perceptual_params = {"spatial_dims": 2, "network_type": "vgg"}
    else:
        perceptual_params = {
            "spatial_dims": 3,
            "network_type": "vgg",
            "is_fake_3d": True,
            "fake_3d_ratio": 0.2,
        }

    discriminator_params = {
        "spatial_dims": spatial_dims,
        "in_channels": autoencoder_dict["in_channels"],
        "out_channels": 1,
        "num_channels": 64,
        "num_layers_d": 3,
    }

    n_epochs = (300 if spatial_dims == 3 else 200) * n_epochs_multiplier
    ae_batch_size = batch_size
    ddpm_batch_size = ae_batch_size * 2

    return {
        "input_channels": list(input_channels),
        "ae_transformations": ae_transformations,
        "ddpm_transformations": ddpm_transformations,
        "ae_batch_size": ae_batch_size,
        "ddpm_batch_size": ddpm_batch_size,
        "n_epochs": n_epochs,
        "val_plot_interval": 10,
        "grad_clip_max_norm": 1,
        "grad_accumulate_step": 1,
        "oversample_ratio": 0.33,
        # False = batch-position oversampling (_oversample_last_XX_percent,
        # the reference default); True = per-sample coin at oversample_ratio
        # (reference _probabilistic_oversampling, data_processing.py:431)
        "probabilistic_oversampling": False,
        "num_workers": 8,
        "lr_scheduler": None,
        "lr_scheduler_params": {"total_iters": n_epochs, "power": 0.9},
        "time_scheduler_params": {
            "num_train_timesteps": 1000,
            "schedule": "scaled_linear_beta",
            "beta_start": 0.0015,
            "beta_end": 0.0205,
            "prediction_type": "epsilon",
        },
        # the pixel-space DDPM trainer's OWN schedule (reference
        # train_ddpm.py:380-381 hardcodes beta 0.0005->0.0195 on MONAI's
        # default linear_beta ramp, distinct from the LDM's scaled-linear
        # 0.0015->0.0205); filter_config_by_mode swaps it in for train_ddpm
        "ddpm_time_scheduler_params": {
            "num_train_timesteps": 1000,
            "schedule": "linear_beta",
            "beta_start": 0.0005,
            "beta_end": 0.0195,
            "prediction_type": "epsilon",
        },
        "ae_learning_rate": 5e-5,
        "d_learning_rate": 5e-5,
        "autoencoder_warm_up_epochs": 5,
        "adv_weight": 0.01,
        "perc_weight": 0.5 if spatial_dims == 2 else 0.125,
        "kl_weight": 1e-6 if spatial_dims == 2 else 1e-7,
        "vae_params": autoencoder_dict,
        "perceptual_params": perceptual_params,
        "discriminator_params": discriminator_params,
        "ddpm_learning_rate": 2e-5,
        "ddpm_params": ddpm_dict,
    }


def epochs_multiplier(n_patients: int) -> int:
    """Dataset-size epoch multiplier (reference configuration.py:1629-1634)."""
    if 0.7 * n_patients < 100:
        return 1
    if 0.7 * n_patients < 500:
        return 2
    return 3


def flagship_dataset(tiny: bool = False, spatial_dims: int = 3) -> Dict:
    """The dataset statistics of the planner's flagship configuration, as
    ``create_*_dict`` take them: a 128^3 median dataset (3D), a dataset of
    max shape (128, 256, 256) (2D), or (16, 16, 16) for the tiny test
    geometry."""
    shape = (16, 16, 16) if tiny else ((128, 128, 128) if spatial_dims == 3 else (128, 256, 256))
    return {"median_shape": shape, "max_shape": shape}


def flagship_configs(tiny: bool = False, spatial_dims: int = 3):
    """(vae_params, ddpm_params, image_size) of the planner's flagship
    configuration, or of its tiny test geometry (the same derivation and
    shrink as the JAX package's ``__graft_entry__._flagship_configs``).

    3D: patch 128^3, KL-VAE [32, 64, 128], latent 32^3 x 8. 2D: patch
    256^2, KL-VAE [64, 128, 256], latent 64^2 x 8, U-Net attention at 32^2
    and 16^2. Tiny: patch 32^3 or 32^2 with narrow channels in both
    networks."""
    ds = flagship_dataset(tiny, spatial_dims)
    vae = create_autoencoder_dict(ds, [0], spatial_dims=spatial_dims)
    ddpm = create_ddpm_dict(ds, spatial_dims=spatial_dims)
    if tiny:
        vae.update(num_channels=[8, 16], norm_num_groups=4, latent_channels=4,
                   num_res_blocks=1)
        ddpm.update(num_channels=[8, 16, 16], num_head_channels=[0, 0, 8],
                    norm_num_groups=4, num_res_blocks=1, in_channels=4,
                    out_channels=4)
    image_size = snap_patch_size(ds["median_shape"], ds["max_shape"], spatial_dims)
    return vae, ddpm, image_size
