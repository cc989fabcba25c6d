"""PyTorch port, conditioning and its variants against the flax modules:
``SpatialTransformer`` (forward and gradients, one and two heads, with and
without a context of another length and width), the conditioned
``DiffusionUNet``, the ControlNet residuals, ``DiffusionEncoder``,
``Upsample(use_convtranspose=True)`` (s * n voxels an axis, the first
s * n - s + 1 equal to the JAX module's whole output, and the JAX module's
s * n - s + 1 shape pinned), the flash wrapper's keys of another length,
and one conditioned LDM ``train_step`` against the JAX
``LDMTrainer._make_train_step``. fp32 on the CPU, tiny sizes, weights
carried across by ``convert.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.models.autoencoder_kl import AutoencoderKL as JAutoencoderKL
from medical_image_generation_tpu.models.blocks import Upsample as JUpsample
from medical_image_generation_tpu.models.diffusion_unet import DiffusionEncoder as JEncoder
from medical_image_generation_tpu.models.diffusion_unet import (
    SpatialTransformer as JSpatialTransformer,
)
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.blocks import Upsample
from medical_image_generation_tpu_torch.models.diffusion_unet import (
    DiffusionEncoder,
    SpatialTransformer,
)
from medical_image_generation_tpu_torch.ops import flash_attention as fa
from medical_image_generation_tpu_torch.planning.planner import flagship_configs
from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer, TrainDraws
from test_torch_augment import jax_draws
from test_torch_training import LR, _config, _jax_trainer
from torch_parity import (
    init_shapes,
    internal,
    nd,
    public,
    rand_params,
    tiny_unet_pair,
    tiny_vae_pair,
)

TOL = dict(rtol=1e-4, atol=1e-4)  # the port's module tolerance, fp32 on the CPU


def _grad_close(got, ref, name):
    scale = float(np.abs(ref).max()) + 1e-12
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("context", ["self", "other"])
def test_spatial_transformer_forward_and_gradients_match_flax(heads, context):
    """Two transformer layers over a 4 x 5 x 3 grid of 16 channels; with a
    context of 7 tokens of width 12 (``other``) the second attention of each
    layer reads keys of another length than its queries, which the flash
    wrapper takes on the CPU. Gradients of x, the context and every
    parameter against ``jax.vjp``."""
    x = nd((2, 4, 5, 3, 16), 1)
    ctx = nd((2, 7, 12), 2) if context == "other" else None
    jm = JSpatialTransformer(16, heads, 2, 4, 3)
    args = (jnp.asarray(x),) + (() if ctx is None else (jnp.asarray(ctx),))
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), *args), 3)
    tm = SpatialTransformer(16, heads, 2, 4, 3, context_dim=None if ctx is None else 12)
    tm.load_state_dict(convert.unet_from_flax(params))
    nn_ctx = tm.TransformerBlock_1.CrossAttention_1.Dense_1.in_features
    assert nn_ctx == (16 if ctx is None else 12)

    def f(p, *a):
        return jm.apply({"params": p}, *a)

    ref, vjp = jax.vjp(f, params, *args)
    cot = nd(x.shape, 4)
    grads = vjp(jnp.asarray(cot))

    xt = internal(x).requires_grad_()
    ct = None if ctx is None else torch.from_numpy(ctx).requires_grad_()
    out = tm(xt, ct)
    np.testing.assert_allclose(public(out), np.asarray(ref), **TOL)
    (out * internal(cot)).sum().backward()
    _grad_close(public(xt.grad), np.asarray(grads[1]), "x")
    if ctx is not None:
        _grad_close(ct.grad.numpy(), np.asarray(grads[2]), "context")
    ref_p = convert.unet_from_flax(jax.tree_util.tree_map(np.asarray, grads[0]))
    named = dict(tm.named_parameters())
    assert set(named) == set(ref_p)
    for name, r in ref_p.items():
        _grad_close(named[name].grad.numpy(), r.numpy(), name)


def _skip_shapes(latent, ddpm_p, batch):
    """Public shapes of the U-Net's collected skips and of its mid block."""
    spatial, chs = list(latent), ddpm_p["num_channels"]
    out = [(batch, *spatial, chs[0])]
    for level, ch in enumerate(chs):
        out += [(batch, *spatial, ch)] * ddpm_p["num_res_blocks"]
        if level != len(chs) - 1:
            spatial = [s // st for s, st in zip(spatial, ddpm_p["strides"][level + 1])]
            out.append((batch, *spatial, ch))
    return out, (batch, *spatial, chs[-1])


@pytest.mark.parametrize("conditioned,residuals", [(True, False), (True, True), (False, True)],
                         ids=["conditioned", "conditioned-controlnet", "controlnet"])
def test_unet_forward_matches_flax(conditioned, residuals):
    """The tiny U-Net with ``with_conditioning`` (a SpatialTransformer at
    its three attention sites, one head at level 1 and two at level 2, two
    transformer layers) and / or ControlNet residuals added to every skip
    and to the mid block."""
    over = dict(with_conditioning=True, transformer_num_layers=2) if conditioned else {}
    jm, params, tm, latent, ddpm_p = tiny_unet_pair(seed=5, **over)
    names = {k.split(".")[0] for k in tm.state_dict()}
    assert any(n.startswith("SpatialTransformer_") for n in names) == conditioned
    assert any(n.startswith("AttentionBlock_") for n in names) != conditioned
    x = nd((2, *latent, ddpm_p["in_channels"]), 6)
    t = np.array([3, 700], np.int32)
    kw_j, kw_t = {}, {}
    if residuals:
        skips, mid = _skip_shapes(latent, ddpm_p, 2)
        down = [nd(s, 10 + i, 0.5) for i, s in enumerate(skips)]
        mid_r = nd(mid, 9, 0.5)
        kw_j = dict(down_block_additional_residuals=[jnp.asarray(r) for r in down],
                    mid_block_additional_residual=jnp.asarray(mid_r))
        kw_t = dict(down_block_additional_residuals=[torch.from_numpy(r) for r in down],
                    mid_block_additional_residual=torch.from_numpy(mid_r))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), **kw_j))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(), **kw_t).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    if residuals:
        plain = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
        assert np.abs(plain - ref).max() > 1e-2  # the residuals move the output


def test_diffusion_encoder_forward_and_gradients_match_flax():
    """``DiffusionEncoder`` at the tiny U-Net's widths (attention at levels
    1 and 2): logits, and the gradients of x and every parameter."""
    _, ddpm_p, _ = flagship_configs(tiny=True)
    geo = {k: tuple(tuple(v) if isinstance(v, list) else v for v in ddpm_p[k])
           for k in ("num_channels", "attention_levels", "num_head_channels", "strides",
                     "kernel_sizes", "paddings")}
    kw = dict(spatial_dims=3, in_channels=4, num_classes=3, num_res_blocks=1,
              norm_num_groups=4, **geo)
    jm = JEncoder(**kw)
    x = nd((2, 16, 16, 16, 4), 7)
    t = np.array([5, 900], np.int32)
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), jnp.asarray(x),
                                     jnp.asarray(t)), 8)
    tm = DiffusionEncoder(**kw)
    tm.load_state_dict(convert.unet_from_flax(params))
    ref, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a, jnp.asarray(t)), params,
                       jnp.asarray(x))
    cot = nd((2, 3), 9)
    gp, gx = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, torch.from_numpy(t).long())
    assert out.shape == (2, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    _grad_close(xt.grad.numpy(), np.asarray(gx), "x")
    ref_p = convert.unet_from_flax(jax.tree_util.tree_map(np.asarray, gp))
    named = dict(tm.named_parameters())
    assert set(named) == set(ref_p)
    for name, r in ref_p.items():
        _grad_close(named[name].grad.numpy(), r.numpy(), name)


@pytest.mark.parametrize("shape,stride", [((2, 4, 5, 3, 6), (2, 2, 2)),
                                          ((1, 3, 4, 5, 6), (1, 2, 2)),
                                          ((2, 5, 4, 6), (2, 2))],
                         ids=["3d-222", "3d-122", "2d-22"])
def test_convtranspose_upsample_gives_sn_and_extends_the_jax_output(shape, stride):
    """``Upsample(use_convtranspose=True)`` (kernel 3, padding 1): the port
    gives s * n voxels an axis, and its first s * n - s + 1 are the JAX
    module's whole output (the same flax kernel, re-laid by the converter);
    gradients of x and the kernel too."""
    sd = len(stride)
    x = nd(shape, 11)
    jm = JUpsample(stride, 3, 1, sd, True)
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), jnp.asarray(x)), 12)
    assert set(params) == {"ConvTranspose_0"}
    ref, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a), params, jnp.asarray(x))
    ref = np.asarray(ref)
    tm = Upsample(shape[-1], stride, sd, True, 3, 1)
    tm.load_state_dict(convert.unet_from_flax(params))
    xt = internal(x).requires_grad_()
    out = tm(xt)
    got = public(out)
    n = shape[1:-1]
    assert got.shape[1:-1] == tuple(s * m for s, m in zip(stride, n))
    assert ref.shape[1:-1] == tuple(s * m - s + 1 for s, m in zip(stride, n))
    lead = (slice(None),) + tuple(slice(m) for m in ref.shape[1:-1])
    np.testing.assert_allclose(got[lead], ref, **TOL)
    # the JAX output's gradient is the port's restricted to those voxels
    cot = nd(ref.shape, 13)
    gp, gx = vjp(jnp.asarray(cot))
    pad = np.zeros(got.shape, np.float32)
    pad[lead] = cot
    (out * internal(pad)).sum().backward()
    _grad_close(public(xt.grad), np.asarray(gx), "x")
    ref_w = convert.unet_from_flax(jax.tree_util.tree_map(np.asarray, gp))
    _grad_close(tm.ConvTranspose_0.weight.grad.numpy(), ref_w["ConvTranspose_0.weight"].numpy(),
                "kernel")


def test_jax_convtranspose_upsample_loses_a_voxel_an_axis():
    """JAX-side finding: flax reads the padding pair (1, 1) as padding of
    the zero-stuffed input, so each transposed-conv level gives 2n - 1
    voxels where the reference gives 2n. The tiny KL-VAE with
    ``use_convtranspose`` reconstructs a 32^3 input as 31^3 in JAX; the
    port's gives 32^3."""
    x = jnp.zeros((1, 4, 4, 4, 8))
    jm = JUpsample((2, 2, 2), 3, 1, 3, True)
    out = jm.apply(jm.init(jax.random.PRNGKey(0), x), x)
    assert out.shape == (1, 7, 7, 7, 8)
    vae_p, _, image = flagship_configs(tiny=True)
    vae_p = dict(vae_p, use_convtranspose=True)
    jvae = JAutoencoderKL.from_config(vae_p, dtype=jnp.float32)
    img = jnp.zeros((1, *image, 1))
    variables = jax.eval_shape(lambda: jvae.init(jax.random.PRNGKey(0), img,
                                                 jax.random.PRNGKey(1)))
    rec = jax.eval_shape(lambda v: jvae.apply(v, img, jax.random.PRNGKey(1)), variables)[0]
    assert rec.shape == (1, 31, 31, 31, 1)
    tvae = AutoencoderKL.from_config(vae_p, dtype=torch.float32, device="cpu")
    sd = convert.vae_from_flax(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), variables["params"]))
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tvae.state_dict().items()}
    with torch.no_grad():
        r, _, _ = tvae(torch.zeros((1, *image, 1)), torch.zeros((1, 16, 16, 16, 4)))
    assert r.shape == (1, 32, 32, 32, 1)


def test_flash_attention_takes_keys_of_another_length_on_every_device():
    """q of 24 tokens against k / v of 10 (two heads): the output and the
    three gradients against autograd through plain softmax attention. Off
    the CPU the length is no longer refused: a meta tensor with Sk != Sq
    meets only the device check (``ValueError``), as one with Sk == Sq
    does."""
    g = torch.Generator().manual_seed(14)
    q = torch.randn((2, 24, 2, 8), generator=g, requires_grad=True)
    k = torch.randn((2, 10, 2, 8), generator=g, requires_grad=True)
    v = torch.randn((2, 10, 2, 8), generator=g, requires_grad=True)
    o, lse = fa.flash_attention(q, k, v, 0.3)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qr, kr) * 0.3
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), vr)
    np.testing.assert_allclose(o.detach().numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).reshape(4, 24).detach()
                               .numpy(), rtol=1e-5, atol=1e-6)
    do = torch.randn(o.shape, generator=g)
    (o * do).sum().backward()
    (ref * do).sum().backward()
    for a, b in ((q, qr), (k, kr), (v, vr)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5, atol=1e-5)
    meta = [t.detach().to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="runs on CUDA or CPU tensors, not meta"):
        fa.flash_attention(*meta, 0.3)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[..., :4], v[..., :4], 0.3)


def test_conditioned_ldm_train_step_matches_jax_make_train_step():
    """One LDM step of the conditioned tiny U-Net (``with_conditioning``,
    no context, as the trainers run it) under the nnunet preset with noise,
    elastic, blur and low resolution on, against the shipped JAX step fed
    the same random numbers; the loss and Adam's first update of every
    parameter (as the AE step's test holds it)."""
    cfg = _config()
    cfg["ddpm_transformations"] = dict(cfg["ddpm_transformations"], aug_preset="nnunet",
                                       gaussian_noise=True, gaussian_blur=True,
                                       low_resolution=True, elastic=True)
    cfg["ddpm_params"] = dict(cfg["ddpm_params"], with_conditioning=True)
    jm, uparams, tunet, latent, ddpm_p = tiny_unet_pair(seed=51, with_conditioning=True)
    jvae, vparams, tvae, _ = tiny_vae_pair(seed=52)
    tr, jcfg, state = _jax_trainer(cfg, jm, uparams, jvae, vparams, 0.7, None)
    initial = compute_initial_patch_size(cfg["ddpm_transformations"])
    x = np.random.default_rng(53).uniform(0, 1, (2, *initial, 1)).astype(np.float32)
    # a key at which scaling (resampled in 3D: rot_3d with rotation off),
    # noise, elastic, blur and low resolution each run on one of the samples
    rng = jax.random.PRNGKey(222)
    aug_rng, enc_rng, t_rng, n_rng, _ = jax.random.split(rng, 5)
    lat = (2, *latent, ddpm_p["in_channels"])
    d = jax_draws(aug_rng, 2, 1, jcfg)
    assert jcfg.rot_3d and all(bool(c.any()) for c in (
        d.scale_on, d.noise_on, d.elastic_on, d.blur_on, d.lowres_on & d.lowres_chan_on[:, 0]))
    draws = TrainDraws(
        augment=d,
        eps=torch.from_numpy(np.array(jax.random.normal(enc_rng, lat, jnp.float32))),
        t=torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 50))).long(),
        noise=torch.from_numpy(np.array(jax.random.normal(n_rng, lat, jnp.float32))))
    trainer = LDMTrainer(cfg, tunet, tvae, device="cpu")
    trainer.scale_factor = 0.7
    p_old = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()}
    state, jloss = tr._make_train_step()(state, vparams, jnp.asarray(x), rng)
    loss = trainer.train_step(torch.from_numpy(x), draws=draws)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    new_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    # |g| from Adam's second moment (1 - b2) g^2, fp32
    g_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(
        lambda a: np.sqrt(np.asarray(a) / 1e-3), state.opt_state[1][0].nu))
    assert set(new_ref) == set(p_old) == set(g_ref)
    for name, p in trainer.unet.named_parameters():
        old = p_old[name]
        u_j = (old - new_ref[name]) / LR - 1e-2 * old
        u_t = (old - p.detach()) / LR - 1e-2 * old
        # as the AE step's test holds it: where |g| is above 1e-2 of the
        # tensor's largest, far above fp32 summation noise, and the JAX
        # |u| > 0.99, the port's u agrees to 1e-3
        g = g_ref[name].abs()
        firm = (u_j.abs() > 0.99) & (g > 1e-2 * g.max())
        assert firm.any(), name
        np.testing.assert_allclose(u_t[firm].numpy(), u_j[firm].numpy(), rtol=0, atol=1e-3,
                                   err_msg=name)
        # |g / (|g| + eps)| <= 1 everywhere, up to the fp32 rounding of p_new
        assert bool((u_t.abs() <= 1.0 + 2.0 ** -22 * old.abs() / LR + 1e-6).all()), name
