"""PyTorch port, stage-1 models: the PatchGAN discriminator and both LSGAN
losses, the perceptual loss (2D and fake-3D, with its gradient, its slice
indices and a synthetic ``MEDIMGEN_VGG_WEIGHTS`` file), the KL-VAE's
training pass and reconstruction, the VQ-VAE (reconstruction, vq loss,
codes, straight-through gradient), the loss helpers and the converters,
each against the JAX package from the same weights and inputs. fp32 on the
CPU, tiny 3D config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.models import discriminator as jdisc
from medical_image_generation_tpu.models import perceptual as jperc
from medical_image_generation_tpu.models.vqvae import VQVAE as JVQVAE
from medical_image_generation_tpu.training import common as jcommon
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.models import discriminator as tdisc
from medical_image_generation_tpu_torch.models import perceptual as tperc
from medical_image_generation_tpu_torch.models import autoencoder_kl
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.models.blocks import ResBlock
from medical_image_generation_tpu_torch.models.vqvae import VQVAE
from medical_image_generation_tpu_torch.planning.planner import flagship_configs
from medical_image_generation_tpu_torch.training import common as tcommon
from torch_parity import init_shapes, nd, rand_params, tiny_vae_pair

# fp32 on both sides: convolutions and reductions summed in another order
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
PLAN = ((8, 1), (16, 2))  # a small feature_plan: two stages, one max-pool


def grad_close(got, ref, name=""):
    """Elementwise |g - ref| <= 1e-4 |ref| + 1e-4 max|ref| (fp32 gradients
    summed in another order)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max()) + 1e-30
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


def images(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def disc_pair(num_channels=8, seed=0):
    """(flax module, flax params, port module) of a 3D PatchDiscriminator
    with the same seeded weights."""
    p = {"spatial_dims": 3, "in_channels": 1, "out_channels": 1,
         "num_channels": num_channels, "num_layers_d": 3}
    jm = jdisc.PatchDiscriminator.from_config(p, dtype=jnp.float32)
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 32, 1))),
                         seed)
    tm = tdisc.PatchDiscriminator.from_config(p, dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.vae_from_flax(params))
    return jm, params, tm, p


def perceptual_pair(spatial_dims=3, plan=PLAN, seed=0, ratio=0.2):
    """(JAX PerceptualLoss, port PerceptualLoss) with the JAX features."""
    jp = jperc.PerceptualLoss(spatial_dims=spatial_dims, is_fake_3d=True, fake_3d_ratio=ratio,
                              seed=seed, dtype=jnp.float32, feature_plan=plan)
    tp = tperc.PerceptualLoss(spatial_dims=spatial_dims, is_fake_3d=True, fake_3d_ratio=ratio,
                              seed=seed, dtype=torch.float32, feature_plan=plan, device="cpu")
    tp.module.load_state_dict(convert.perceptual_from_flax(jax.device_get(jp.params)))
    return jp, tp


def vq_pair(seed=5):
    """(flax VQVAE, flax params, port VQVAE, vae_params) of the tiny config."""
    vae_p, _, image = flagship_configs(tiny=True)
    jm = JVQVAE.from_config(vae_p, dtype=jnp.float32)
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), jnp.zeros((1, *image, 1))),
                         seed)
    tm = VQVAE.from_config(vae_p, dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.vae_from_flax(params))
    return jm, params, tm, vae_p


# --------------------------------------------------------------- discriminator


def test_discriminator_logits_and_lsgan_losses_match_jax():
    jm, params, tm, _ = disc_pair(seed=1)
    real, fake = images((2, 32, 32, 32, 1), 2), images((2, 32, 32, 32, 1), 3)
    apply = jax.jit(jm.apply)
    jr = np.asarray(apply({"params": params}, jnp.asarray(real)))
    jf = np.asarray(apply({"params": params}, jnp.asarray(fake)))
    with torch.no_grad():
        tr, tf = tm(torch.from_numpy(real)), tm(torch.from_numpy(fake))
    assert tr.shape == (2, 6, 6, 6, 1) and tr.dtype == torch.float32
    np.testing.assert_allclose(tr.numpy(), jr, **OUT_TOL)
    np.testing.assert_allclose(tf.numpy(), jf, **OUT_TOL)
    g_j = jdisc.least_squares_gan_loss(logits_fake=jnp.asarray(jf))
    d_j = jdisc.least_squares_gan_loss(logits_real=jnp.asarray(jr), logits_fake=jnp.asarray(jf))
    np.testing.assert_allclose(tdisc.least_squares_gan_loss(logits_fake=tf).item(), float(g_j),
                               rtol=1e-4)
    np.testing.assert_allclose(
        tdisc.least_squares_gan_loss(logits_real=tr, logits_fake=tf).item(), float(d_j),
        rtol=1e-4)


def test_discriminator_names_and_instance_norms():
    """Flax names one to one; every GroupNorm has one channel a group; the
    middle convs have no bias."""
    _, params, tm, _ = disc_pair(num_channels=64, seed=4)
    assert set(tm.state_dict()) == set(convert.vae_from_flax(params))
    gns = [m for m in tm.modules() if isinstance(m, torch.nn.Module)
           and type(m).__name__ == "GroupNorm"]
    assert [(g.num_groups, g.weight.numel()) for g in gns] == [(128, 128), (256, 256)]
    assert tm.ConvND_1.Conv_0.bias is None and tm.ConvND_2.Conv_0.bias is None
    assert tm.ConvND_0.Conv_0.bias is not None and tm.ConvND_3.Conv_0.bias is not None


# ------------------------------------------------------------------ perceptual


@pytest.mark.parametrize("spatial_dims", [2, 3])
def test_perceptual_loss_and_its_gradient_match_jax(spatial_dims):
    """The loss (2D, and fake-3D over slices of every axis) and its
    gradient with respect to pred; the features stay frozen."""
    jp, tp = perceptual_pair(spatial_dims, seed=6)
    shape = (2, 24, 24, 1) if spatial_dims == 2 else (2, 16, 24, 20, 1)
    pred, target = images(shape, 7), images(shape, 8)
    jl, jg = jax.jit(jax.value_and_grad(jp))(jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    loss = tp(p, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    grad_close(p.grad.numpy(), jg, "d loss / d pred")
    assert all(not q.requires_grad and q.grad is None for q in tp.parameters())


def test_perceptual_full_vgg_plan_small_input_matches_jax():
    """The full VGG16 plan on slices too small for every stage: the pyramid
    stops early in both packages."""
    jp, tp = perceptual_pair(3, plan=None, seed=9, ratio=0.25)
    pred, target = images((1, 8, 12, 8, 1), 10), images((1, 8, 12, 8, 1), 11)
    jl = jax.jit(jp)(jnp.asarray(pred), jnp.asarray(target))
    with torch.no_grad():
        tl = tp(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)


def _pairs():
    sizes = list(range(1, 161))
    pairs = {(s, max(1, int(s * 0.2))) for s in sizes}
    pairs |= {(128, 25), (32, 6), (24, 4), (20, 4), (16, 3), (143, 28), (12, 3), (8, 2)}
    pairs |= {(s, n) for s in (7, 13, 29, 64, 100, 127) for n in (1, 2, 3, 5, 9)}
    return sorted(p for p in pairs if p[1] <= p[0])


def test_slice_indices_equal_jax_linspace():
    """For every (size, n) the tests and the flagship use, and a sweep: the
    port's indices equal jnp.linspace(0, size - 1, n).astype(int32), eager
    and under jit (float32 truncation near an integer is where they could
    part)."""
    for size, n in _pairs():
        want = np.asarray(jnp.linspace(0, size - 1, n).astype(jnp.int32))
        np.testing.assert_array_equal(tperc.slice_indices(size, n), want,
                                      err_msg=f"{(size, n)}")
    for size, n in ((128, 25), (32, 6), (16, 3), (143, 28)):
        jit_idx = jax.jit(lambda: jnp.linspace(0, size - 1, n).astype(jnp.int32))()
        np.testing.assert_array_equal(tperc.slice_indices(size, n), np.asarray(jit_idx))
    assert tperc.slice_indices(128, 25)[-1] == 127 and len(tperc.slice_indices(128, 25)) == 25


def test_vgg_weights_npz_gives_the_same_loss(tmp_path, monkeypatch):
    """A synthetic MEDIMGEN_VGG_WEIGHTS .npz (flax keys and layout) loaded
    by both packages: the same loss; without it the port keeps its own
    seeded features (lecun_normal: std sqrt(1 / fan_in), zero bias)."""
    rng = np.random.default_rng(12)
    data, fan_in = {}, 3
    for s, (ch, n) in enumerate(PLAN):
        for i in range(n):
            data[f"conv{s}_{i}.kernel"] = (rng.standard_normal((3, 3, fan_in, ch))
                                           / np.sqrt(9 * fan_in)).astype(np.float32)
            data[f"conv{s}_{i}.bias"] = (0.1 * rng.standard_normal(ch)).astype(np.float32)
            fan_in = ch
    path = tmp_path / "vgg.npz"
    np.savez(path, **data)
    plain = tperc.PerceptualLoss(3, dtype=torch.float32, feature_plan=PLAN, seed=3)
    w = plain.module.conv1_1.weight
    assert torch.equal(plain.module.conv0_0.bias, torch.zeros(8))
    assert abs(float(w.std()) - (1 / (9 * 16)) ** 0.5) < 0.1 * (1 / (9 * 16)) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / (9 * 16)) ** 0.5 / 0.87962566103423978
    again = tperc.PerceptualLoss(3, dtype=torch.float32, feature_plan=PLAN, seed=3)
    assert torch.equal(again.module.conv1_1.weight, w)

    monkeypatch.setenv("MEDIMGEN_VGG_WEIGHTS", str(path))
    jp = jperc.PerceptualLoss(3, dtype=jnp.float32, feature_plan=PLAN)
    tp = tperc.PerceptualLoss(3, dtype=torch.float32, feature_plan=PLAN)
    np.testing.assert_array_equal(tp.module.conv1_1.weight.permute(2, 3, 1, 0).numpy(),
                                  data["conv1_1.kernel"])
    pred, target = images((2, 16, 16, 16, 1), 13), images((2, 16, 16, 16, 1), 14)
    jl = jax.jit(jp)(jnp.asarray(pred), jnp.asarray(target))
    with torch.no_grad():
        tl = tp(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)


# --------------------------------------------------------------------- KL-VAE


def test_autoencoder_forward_and_reconstruct_match_jax():
    """forward(x, eps) = (decode(mu + sigma eps), mu, sigma) and
    reconstruct(x) = decode(mu), against __call__ (fed the same eps) and
    reconstruct of the flax module; fp32 master params under fp32 compute."""
    jm, params, tm, vae_p = tiny_vae_pair(seed=15)
    x = images((2, 32, 32, 32, 1), 16)
    rng = jax.random.PRNGKey(17)
    jrec, jmu, jsig = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), rng)
    eps = np.asarray(jax.random.normal(rng, jmu.shape, jmu.dtype))
    with torch.no_grad():
        rec, mu, sig = tm(torch.from_numpy(x), torch.from_numpy(eps))
        rc = tm.reconstruct(torch.from_numpy(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **OUT_TOL)
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), **OUT_TOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), **OUT_TOL)
    jrc = jax.jit(lambda p, x: jm.apply(p, x, method=jm.reconstruct))({"params": params},
                                                                      jnp.asarray(x))
    np.testing.assert_allclose(rc.numpy(), np.asarray(jrc), **OUT_TOL)
    assert rec.dtype == torch.float32 and rec.shape == x.shape


def test_autoencoder_param_dtype_and_checkpointing_refusal():
    """bf16 compute over fp32 master params (the JAX AE's layout): every
    conv weight fp32, the output fp32. The models build from a config with
    use_checkpointing, the flag reaches the Encoder's and the Decoder's
    ResBlocks, the state_dict keys stay, and an unknown remat_policy is
    refused."""
    vae_p, _, _ = flagship_configs(tiny=True)
    m = AutoencoderKL.from_config(vae_p, dtype=torch.bfloat16, param_dtype=torch.float32,
                                  device="cpu")
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    x = torch.rand((1, 32, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    eps = torch.randn((1, 16, 16, 16, vae_p["latent_channels"]))
    rec, mu, sig = m(x, eps)
    assert rec.dtype == mu.dtype == torch.float32 and torch.isfinite(rec).all()
    remat = dict(vae_p, use_checkpointing=True)
    assert set(AutoencoderKL.from_config(remat, device="cpu").state_dict()) == set(
        m.state_dict())
    VQVAE.from_config(remat, device="cpu")
    for cls in (AutoencoderKL, VQVAE):
        r = cls.from_config(dict(remat, remat_policy="full"), dtype=torch.float32,
                            device="cpu")
        blocks = [b for b in r.modules() if isinstance(b, ResBlock)]
        seen = []
        orig = autoencoder_kl.checkpoint.checkpoint
        autoencoder_kl.checkpoint.checkpoint = lambda fn, *a, **k: (seen.append(fn), fn(*a))[1]
        try:
            r(x) if cls is VQVAE else r(x, eps)
        finally:
            autoencoder_kl.checkpoint.checkpoint = orig
        assert len(blocks) > 0 and [id(b) for b in seen] == [id(b) for b in blocks]
        with pytest.raises(ValueError, match="remat_policy"):
            cls.from_config(dict(remat, remat_policy="bogus"), device="cpu")


def test_kl_and_l1_losses_match_jax():
    mu, sig = nd((2, 4, 4, 4, 3), 18), np.exp(nd((2, 4, 4, 4, 3), 19, 0.3))
    np.testing.assert_allclose(tcommon.kl_loss(torch.from_numpy(mu), torch.from_numpy(sig)).item(),
                               float(jcommon.kl_loss(jnp.asarray(mu), jnp.asarray(sig))),
                               rtol=1e-6)
    a, b = nd((2, 5, 5, 1), 20), nd((2, 5, 5, 1), 21)
    np.testing.assert_allclose(tcommon.l1_loss(torch.from_numpy(a), torch.from_numpy(b)).item(),
                               float(jcommon.l1_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


# --------------------------------------------------------------------- VQ-VAE


def test_vqvae_recon_loss_codes_and_straight_through_match_jax():
    """Reconstruction, vq loss, codes and the stage-2 hooks; the gradient
    with respect to the encoder's params through the straight-through
    estimator (and to the codebook through the codebook loss) against
    jax.grad."""
    jm, params, tm, _ = vq_pair(seed=22)
    x = images((2, 32, 32, 32, 1), 23)
    jrec, jvq = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    jz = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode))({"params": params},
                                                              jnp.asarray(x))
    _, _, jcodes = jax.jit(lambda p, z: jm.apply(p, z, method=jm.quantize))({"params": params},
                                                                           jz)
    rec, vq = tm(torch.from_numpy(x))
    z = tm.encode(torch.from_numpy(x))
    _, _, codes = tm.quantize(z)
    np.testing.assert_allclose(rec.detach().numpy(), np.asarray(jrec), **OUT_TOL)
    np.testing.assert_allclose(vq.item(), float(jvq), rtol=1e-4)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert codes.shape == (2, 16, 16, 16)
    with torch.no_grad():
        dec = tm.decode_stage_2_outputs(z)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jrec), **OUT_TOL)

    def loss_fn(p):
        r, v = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jnp.abs(r - jnp.asarray(x))) + v

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = torch.mean(torch.abs(rec - torch.from_numpy(x))) + vq
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    ref = convert.vae_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for name in ("encoder.ConvND_0.Conv_0.weight", "encoder.ConvND_1.Conv_0.weight",
                 "decoder.ConvND_0.Conv_0.weight", "quantizer.codebook"):
        grad_close(got[name].grad.numpy(), ref[name].numpy(), name)


def test_vq_codebook_init_is_uniform_in_range():
    q = VQVAE(num_channels=(8, 16), norm_num_groups=4, num_res_blocks=1,
              downsample_parameters=[[1, 3, 1], [2, 3, 1]], upsample_parameters=[[2, 3, 1]],
              num_embeddings=64, embedding_dim=4, device="cpu").quantizer.codebook
    assert q.shape == (64, 4) and float(q.min()) >= 0 and float(q.max()) < 2 / 64
    assert float(q.max()) > 0.9 * 2 / 64 and q.dtype == torch.float32


# ------------------------------------------------------------------ converters


def test_converters_map_every_flax_param():
    """discriminator / perceptual / VQ-VAE / KL-VAE converters: every flax
    leaf lands on a port parameter of the same size, the codebook
    unchanged, conv kernels re-laid-out, and a KL-VAE with fp32 masters
    keeps the converted fp32 values bit for bit."""
    _, dparams, dm, _ = disc_pair(seed=24)
    assert set(dm.state_dict()) == set(convert.vae_from_flax(dparams))
    jp, tp = perceptual_pair(3, seed=25)
    sd = convert.perceptual_from_flax(jax.device_get(jp.params))
    assert set(sd) == set(tp.module.state_dict())
    np.testing.assert_array_equal(sd["conv0_0.weight"].permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jp.params["params"]["conv0_0"]["kernel"]))
    _, vparams, vm, _ = vq_pair(seed=26)
    vsd = convert.vae_from_flax(vparams)
    np.testing.assert_array_equal(vsd["quantizer.codebook"].numpy(),
                                  vparams["quantizer"]["codebook"])
    assert all(vsd[k].shape == v.shape for k, v in vm.state_dict().items())
    _, kparams, _, vae_p = tiny_vae_pair(seed=27)
    ksd = convert.vae_from_flax(kparams)
    m = AutoencoderKL.from_config(vae_p, dtype=torch.bfloat16, param_dtype=torch.float32,
                                  device="cpu")
    m.load_state_dict(ksd)
    assert all(torch.equal(v, ksd[k]) for k, v in m.state_dict().items())
