"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
seeded random flax parameter trees, numpy <-> torch layout moves, and the
tiny 3D U-Net / VAE built in both packages with the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from medical_image_generation_tpu.models.autoencoder_kl import AutoencoderKL as JAutoencoderKL
from medical_image_generation_tpu.models.diffusion_unet import DiffusionUNet as JDiffusionUNet
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.planning.planner import (
    compute_output_size,
    flagship_configs,
)


def rand_params(tree, seed=0):
    """Replace every leaf of a flax param tree with seeded normals: fan-in
    scaled for kernels, 1 + 0.1 n for GroupNorm scales, 0.1 n otherwise.
    Returns nested dicts of fp32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def rec(node):
        out = {}
        for k, v in node.items():
            if hasattr(v, "items"):
                out[k] = rec(v)
                continue
            shape = np.shape(v)
            n = rng.standard_normal(shape).astype(np.float32)
            if k == "kernel":
                out[k] = n / np.sqrt(np.prod(shape[:-1]))
            elif k == "scale":
                out[k] = 1.0 + 0.1 * n
            else:
                out[k] = 0.1 * n
        return out

    return rec(tree)


def nd(shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


def internal(a: np.ndarray) -> torch.Tensor:
    """(B, *spatial, C) numpy -> N C *spatial channels-last torch view."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


def public(t: torch.Tensor) -> np.ndarray:
    """N C *spatial torch -> (B, *spatial, C) numpy."""
    return t.permute(0, *range(2, t.dim()), 1).detach().float().numpy()


def tiny_unet_pair(num_class_embeds=None, seed=0):
    """(flax module, flax params, port module) of the tiny 3D U-Net with
    the same seeded weights."""
    vae_p, ddpm_p, image = flagship_configs(tiny=True)
    ddpm_p = dict(ddpm_p, num_class_embeds=num_class_embeds)
    latent = compute_output_size(image, vae_p["downsample_parameters"])
    jm = JDiffusionUNet.from_config(ddpm_p, dtype=jnp.float32)
    x = jnp.zeros((1, *latent, ddpm_p["in_channels"]))
    kw = {} if num_class_embeds is None else {"class_labels": jnp.zeros((1,), jnp.int32)}
    params = rand_params(jm.init(jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32),
                                 **kw)["params"], seed)
    tm = DiffusionUNet.from_config(ddpm_p, dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.unet_from_flax(params))
    return jm, params, tm.eval(), latent, ddpm_p


def tiny_vae_pair(seed=1):
    """(flax module, flax params, port module, vae_params) of the tiny 3D
    KL-VAE, encoder and decoder, with the same seeded weights."""
    vae_p, _, image = flagship_configs(tiny=True)
    jm = JAutoencoderKL.from_config(vae_p, dtype=jnp.float32)
    params = rand_params(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *image, 1)),
                                 jax.random.PRNGKey(1))["params"], seed)
    tm = AutoencoderKL.from_config(vae_p, dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.vae_from_flax(params))
    return jm, params, tm.eval(), vae_p
