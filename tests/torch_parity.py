"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
seeded random flax parameter trees, numpy <-> torch layout moves, and the
tiny 3D (or, with ``spatial_dims=2``, 2D) U-Net / VAE built in both
packages with the same weights."""

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

# One intra-op thread in each test process. The suite runs six xdist workers
# on an 8-core box, each also running XLA's own thread pool; torch's default
# of one OpenMP thread per core then oversubscribes the cores, and its
# threads spin at every parallel region's barrier while others hold the
# cores (a CLI test of 8 s alone took 535 s in the suite). The tiny CPU
# parity sizes gain nothing from more threads. Every worker imports this
# module when it collects the test files.
torch.set_num_threads(1)


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


def init_shapes(module, *args, **kwargs):
    """The flax ``params`` tree of ``module.init(*args)`` as shapes only
    (``jax.eval_shape``; the op-by-op init of the tiny U-Net takes ~40 s on
    the CPU, and ``rand_params`` replaces every value), its dicts in the
    init's own key order, which ``rand_params`` draws in (``eval_shape``
    returns them sorted)."""
    order = []

    def keys(node):
        return [(k, keys(v) if hasattr(v, "items") else None) for k, v in node.items()]

    def init():
        params = module.init(*args, **kwargs)["params"]
        order.append(keys(params))
        return params

    def reorder(node, spec):
        return {k: reorder(node[k], sub) if sub is not None else node[k] for k, sub in spec}

    return reorder(jax.eval_shape(init), order[0])


def nd(shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


def internal(a: np.ndarray) -> torch.Tensor:
    """(B, *spatial, C) numpy -> N C *spatial channels-last torch view."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


def public(t: torch.Tensor) -> np.ndarray:
    """N C *spatial torch -> (B, *spatial, C) numpy."""
    return t.permute(0, *range(2, t.dim()), 1).detach().float().numpy()


def tiny_unet_pair(num_class_embeds=None, seed=0, spatial_dims=3, **ddpm_over):
    """(flax module, flax params, port module, latent, ddpm_params) of the
    tiny 3D (or 2D) U-Net with the same seeded weights; ``ddpm_over``
    overrides ddpm_params keys (``with_conditioning=True``, ...)."""
    vae_p, ddpm_p, image = flagship_configs(tiny=True, spatial_dims=spatial_dims)
    ddpm_p = dict(ddpm_p, num_class_embeds=num_class_embeds, **ddpm_over)
    latent = compute_output_size(image, vae_p["downsample_parameters"])
    jm = JDiffusionUNet.from_config(ddpm_p, dtype=jnp.float32)
    x = jnp.zeros((1, *latent, ddpm_p["in_channels"]))
    kw = {} if num_class_embeds is None else {"class_labels": jnp.zeros((1,), jnp.int32)}
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32),
                                     **kw), seed)
    tm = DiffusionUNet.from_config(ddpm_p, dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.unet_from_flax(params))
    return jm, params, tm.eval(), latent, ddpm_p


def tiny_vae_pair(seed=1, spatial_dims=3):
    """(flax module, flax params, port module, vae_params) of the tiny 3D
    (or 2D) KL-VAE, encoder and decoder, with the same seeded weights."""
    vae_p, _, image = flagship_configs(tiny=True, spatial_dims=spatial_dims)
    jm = JAutoencoderKL.from_config(vae_p, dtype=jnp.float32)
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), jnp.zeros((1, *image, 1)),
                                     jax.random.PRNGKey(1)), seed)
    tm = AutoencoderKL.from_config(vae_p, dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.vae_from_flax(params))
    return jm, params, tm.eval(), vae_p
