"""Planner math for model configs: the port's own copy.

Copied from ``medical_image_generation_tpu/planning/planner.py`` (the
numpy-free functions at :28-169) so the port builds planner configs without
importing the JAX package. Same semantics: the nnU-Net-style per-axis
stride/kernel/padding derivation and the KL-VAE / diffusion U-Net
architecture dicts derived from a dataset's median shape.
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


def flagship_configs(tiny: bool = False):
    """(vae_params, ddpm_params, image_size) of the planner's flagship 3D
    configuration for a 128^3 median dataset, or of its tiny test geometry
    (the same derivation and shrink as the JAX package's
    ``__graft_entry__._flagship_configs``)."""
    median = (16, 16, 16) if tiny else (128, 128, 128)
    ds = {"median_shape": median, "max_shape": median}
    vae = create_autoencoder_dict(ds, [0], spatial_dims=3)
    ddpm = create_ddpm_dict(ds, spatial_dims=3)
    if tiny:
        vae.update(num_channels=[8, 16], norm_num_groups=4, latent_channels=4,
                   num_res_blocks=1)
        ddpm.update(num_channels=[8, 16, 16], num_head_channels=[0, 0, 8],
                    norm_num_groups=4, num_res_blocks=1, in_channels=4,
                    out_channels=4)
    image_size = snap_patch_size(median, median, 3)
    return vae, ddpm, image_size
