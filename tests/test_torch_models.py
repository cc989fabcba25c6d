"""PyTorch port, models: blocks, the tiny diffusion U-Net and the tiny VAE
decode against the JAX package's flax modules, in fp32 on the CPU, with the
same seeded weights loaded through the port's converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.models import blocks as jblocks
from medical_image_generation_tpu.models.diffusion_unet import DiffusionUNet as JDiffusionUNet
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.models import blocks as tblocks
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.planning.planner import flagship_configs
from torch_parity import (
    init_shapes,
    internal,
    nd,
    public,
    rand_params,
    tiny_unet_pair,
    tiny_vae_pair,
)

# fp32 on the CPU, summation order only (convs, matmuls and GroupNorm sums
# reduce in another order than XLA)
TOL = dict(rtol=1e-4, atol=1e-4)


def _load(module, tree):
    module.load_state_dict(convert.flax_to_state_dict(tree))
    return module.eval()


@pytest.mark.parametrize("cin,cout,temb,skip", [(8, 8, False, 0), (8, 16, True, 0),
                                                (8, 8, True, 8)])
def test_resblock_matches_flax(cin, cout, temb, skip):
    x = nd((2, 4, 6, 4, cin), 0)
    t = nd((2, 12), 1) if temb else None
    s = nd((2, 4, 6, 4, skip), 2) if skip else None
    jmod = jblocks.ResBlock(cout, 4, 1e-6, 3, dtype=jnp.float32)
    args = [jnp.asarray(x), None if t is None else jnp.asarray(t),
            None if s is None else jnp.asarray(s)]
    params = rand_params(init_shapes(jmod, jax.random.PRNGKey(0), *args), 3)
    ref = np.asarray(jmod.apply({"params": params}, *args))
    tmod = _load(tblocks.ResBlock(cin + skip, cout, 4, 1e-6, 3, 12 if temb else None), params)
    h = internal(x) if s is None else torch.cat([internal(x), internal(s)], dim=1)
    with torch.no_grad():
        got = tmod(h, None if t is None else torch.from_numpy(t))
    np.testing.assert_allclose(public(got), ref, **TOL)


@pytest.mark.parametrize("head_ch", [-1, 8])
def test_attention_block_matches_flax(head_ch):
    x = nd((2, 4, 4, 2, 16), 4)
    jmod = jblocks.AttentionBlock(head_ch, 4, dtype=jnp.float32)
    params = rand_params(init_shapes(jmod, jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = _load(tblocks.AttentionBlock(16, head_ch, 4), params)
    with torch.no_grad():
        got = tmod(internal(x))
    np.testing.assert_allclose(public(got), ref, **TOL)


def test_timestep_embedding_cos_then_sin():
    t = np.array([0, 3, 999], np.int32)
    ref = np.asarray(jblocks.timestep_embedding(jnp.asarray(t), 9))
    got = tblocks.timestep_embedding(torch.from_numpy(t).long(), 9).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_labels", [False, True])
def test_tiny_unet_matches_flax(with_labels):
    jm, params, tm, latent, ddpm_p = tiny_unet_pair(3 if with_labels else None)
    x = nd((2, *latent, ddpm_p["in_channels"]), 6)
    t = np.array([5, 870], np.int32)
    labels = np.array([2, 0], np.int32) if with_labels else None
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                              class_labels=None if labels is None else jnp.asarray(labels)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                 class_labels=None if labels is None else torch.from_numpy(labels).long())
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_tiny_vae_decode_matches_flax():
    jm, params, tm, vae_p = tiny_vae_pair()
    z = nd((2, 16, 16, 16, vae_p["latent_channels"]), 7)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(z), method=jm.decode))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z))
    assert got.shape == (2, 32, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the decoding half alone (what the sampler builds) from the decoder's params
    half = AutoencoderKL.from_config(vae_p, dtype=torch.float32, device="cpu",
                                     with_encoder=False)
    half.load_state_dict(convert.vae_decoder_from_flax(params))
    with torch.no_grad():
        torch.testing.assert_close(half.eval().decode(torch.from_numpy(z)), got, rtol=0, atol=0)


def test_converter_migrates_legacy_groupnorm_nesting():
    tree = {"ResBlock_0": {"GroupNorm_0": {"GroupNorm_0": {"scale": np.ones(4),
                                                           "bias": np.zeros(4)}},
                           "ConvND_0": {"Conv_0": {"kernel": np.zeros((3, 3, 3, 4, 2)),
                                                   "bias": np.zeros(2)}}}}
    sd = convert.unet_from_flax(tree)
    assert set(sd) == {"ResBlock_0.GroupNorm_0.weight", "ResBlock_0.GroupNorm_0.bias",
                       "ResBlock_0.ConvND_0.Conv_0.weight", "ResBlock_0.ConvND_0.Conv_0.bias"}
    assert sd["ResBlock_0.ConvND_0.Conv_0.weight"].shape == (2, 4, 3, 3, 3)


def test_flagship_unet_geometry():
    """Flagship config (shapes only, on the meta device): ~441M parameters and
    11 attention sites, 5 at 16^3 tokens x 512 and 6 at 8^3 tokens x 768."""
    _, ddpm_p, _ = flagship_configs()
    with torch.device("meta"):
        m = DiffusionUNet.from_config(ddpm_p)
    assert sum(p.numel() for p in m.parameters()) == 441_490_952
    attn = [mod for mod in m.modules() if isinstance(mod, tblocks.AttentionBlock)]
    assert sorted(a.head_dim for a in attn) == [512] * 5 + [768] * 6


@pytest.mark.parametrize("extra", [{}, {"cross_attention_dim": 32, "transformer_num_layers": 2}])
def test_unet_from_config_with_conditioning_builds_the_flax_tree(extra):
    """Under with_conditioning the JAX U-Net puts a SpatialTransformer at
    every attention site, and so does the port: with and without it, the
    port's parameters are the flax tree's (the trainers initialise flax
    without a context, so ``cross_attention_dim`` sizes nothing in either
    package; ``transformer_num_layers`` stacks TransformerBlocks)."""
    _, ddpm_p, _ = flagship_configs(tiny=True)
    x = jnp.zeros((1, 16, 16, 16, ddpm_p["in_channels"]))
    for cond in (True, False):
        cfg = dict(ddpm_p, with_conditioning=cond, **extra)
        tm = DiffusionUNet.from_config(cfg, dtype=torch.float32, device="meta")
        jm = JDiffusionUNet.from_config(cfg, dtype=jnp.float32)
        tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                              jnp.zeros((1,), jnp.int32))["params"])
        ref = convert.unet_from_flax(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), tree))
        assert {k: tuple(v.shape) for k, v in ref.items()} == \
            {k: tuple(v.shape) for k, v in tm.state_dict().items()}
        layers = {k.split(".")[1] for k in ref if k.startswith("SpatialTransformer_0.")
                  and k.split(".")[1].startswith("TransformerBlock_")}
        assert len(layers) == (extra.get("transformer_num_layers", 1) if cond else 0)
