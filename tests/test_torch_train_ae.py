"""PyTorch port, stage-1 training: one ``AutoEncoderTrainer.train_step``
against the shipped JAX ``AutoEncoderTrainer._make_train_step(adv_on)`` for
{vae, vq} x {adversarial loss off, on}, from the same weights and the same
random numbers (split as ``aug_rng, samp_rng, d_rng``); the ``auto``
kl_weight against ``adapt_kl_loss_weight``; ``parse_kl_weight``; and
``filter_config_by_mode(..., "train_autoencoder")`` against the JAX one.
fp32 on the CPU, tiny 3D config (a narrow discriminator and a two-stage
perceptual feature plan keep it quick)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.config import run as jrun
from medical_image_generation_tpu.data.augment import AugmentConfig as JAugmentConfig
from medical_image_generation_tpu.models.autoencoder_kl import AutoencoderKL as JAutoencoderKL
from medical_image_generation_tpu.models.discriminator import PatchDiscriminator as JDisc
from medical_image_generation_tpu.models.perceptual import PerceptualLoss as JPerceptual
from medical_image_generation_tpu.models.vqvae import VQVAE as JVQVAE
from medical_image_generation_tpu.training import common as jcommon
from medical_image_generation_tpu.training import train_autoencoder as jtrain_ae
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.config import run as trun
from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
from medical_image_generation_tpu_torch.models.discriminator import PatchDiscriminator
from medical_image_generation_tpu_torch.models.perceptual import PerceptualLoss
from medical_image_generation_tpu_torch.training import common as tcommon
from medical_image_generation_tpu_torch.training import train_autoencoder as ttrain_ae
from medical_image_generation_tpu_torch.training.common import build_generator
from medical_image_generation_tpu_torch.training.train_autoencoder import (
    AEDraws,
    AutoEncoderTrainer,
)
from test_torch_augment import jax_draws
from test_torch_training import _config
from torch_parity import init_shapes, rand_params

LR = 5e-5


def ae_config(**over):
    """The tiny config with a narrow discriminator, a two-stage perceptual
    plan, and loss weights large enough that every term moves the
    gradients."""
    cfg = _config()
    cfg["discriminator_params"] = dict(cfg["discriminator_params"], num_channels=8)
    cfg["perceptual_params"] = dict(cfg["perceptual_params"], feature_plan=[[8, 1], [16, 1]])
    cfg.update(kl_weight=1e-4, adv_weight=0.5, q_weight=1.0)
    cfg.update(over)
    return cfg


def jax_and_port(cfg, latent, seed):
    """(JAX trainer, g_state, d_state, port trainer) from the same seeded
    weights; the JAX trainer carries what ``_make_train_step`` reads."""
    sd = cfg["vae_params"]["spatial_dims"]
    x0 = jnp.zeros((1, *cfg["ae_transformations"]["patch_size"][-sd:], 1))
    k0, k1 = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    if latent == "vae":
        jm = JAutoencoderKL.from_config(cfg["vae_params"], dtype=jnp.float32)
        gp = rand_params(init_shapes(jm, {"params": k0}, x0, k1), seed)
        g_sd = convert.vae_from_flax(gp)
    else:
        jm = JVQVAE.from_config(cfg["vae_params"], dtype=jnp.float32)
        gp = rand_params(init_shapes(jm, {"params": k0}, x0), seed)
        g_sd = convert.vae_from_flax(gp)
    jd = JDisc.from_config(cfg["discriminator_params"], dtype=jnp.float32)
    dp = rand_params(init_shapes(jd, k1, x0), seed + 1)
    jp = JPerceptual.from_config(cfg["perceptual_params"], dtype=jnp.float32)

    tr = object.__new__(jtrain_ae.AutoEncoderTrainer)
    tr.config, tr.latent_space_type = cfg, latent
    tr.model, tr.discriminator, tr.perceptual = jm, jd, jp
    tr.adv_weight, tr.perc_weight = cfg["adv_weight"], cfg["perc_weight"]
    tr.auto_kl_weight, tr.kl_weight = jtrain_ae.parse_kl_weight(cfg.get("kl_weight"))
    tr.q_weight = cfg["q_weight"]
    tr.aug_cfg = JAugmentConfig.from_transformations(cfg["ae_transformations"], spatial_dims=sd)

    def state(apply_fn, params):
        tx = jcommon.make_optimizer(jcommon.make_lr_schedule(LR, None, None, 250), 1.0, 1)
        return jcommon.TrainState.create(apply_fn=apply_fn, params=params, tx=tx)

    tm = build_generator(cfg, latent, torch.float32, device="cpu")
    tm.load_state_dict(g_sd)
    td = PatchDiscriminator.from_config(cfg["discriminator_params"], dtype=torch.float32,
                                        device="cpu")
    td.load_state_dict(convert.vae_from_flax(dp))
    tp = PerceptualLoss.from_config(cfg["perceptual_params"], dtype=torch.float32, device="cpu")
    tp.module.load_state_dict(convert.perceptual_from_flax(jax.device_get(jp.params)))
    port = AutoEncoderTrainer(cfg, tm, td, tp, latent, device="cpu")
    return tr, state(jm.apply, gp), state(jd.apply, dp), port


def jax_mu(jstate):
    """Adam's first moment of a JAX TrainState, as a port state_dict."""
    return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             jstate.opt_state[1][0].mu))


def check_first_adam_update(old, new, ref, ref_mu, names, what):
    """Adam's first update with weight decay 0 is -lr * g / (|g| + eps):
    u = (p_old - p_new) / lr is about sign(g). Where the JAX gradient
    (mu / (1 - b1)) is above 1e-2 of its tensor's largest, and so far above the
    fp32 summation noise that ``check_mu`` allows, and the JAX |u| > 0.99,
    the port's u agrees to 1e-3. Everywhere |u| <= 1; a parameter with no
    gradient in JAX (a VQ code no latent chose) stays exactly where it was
    in the port too."""
    for n in names:
        u_j = (old[n] - ref[n]) / LR
        u_t = (old[n] - new[n]) / LR
        g = ref_mu[n].abs()
        firm = (u_j.abs() > 0.99) & (g > 1e-2 * g.max())
        assert firm.any(), f"{what} {n}"
        np.testing.assert_allclose(u_t[firm].numpy(), u_j[firm].numpy(), rtol=0, atol=1e-3,
                                   err_msg=f"{what} {n}")
        assert bool((u_t.abs() <= 1.0 + 2.0 ** -22 * old[n].abs() / LR + 1e-6).all()), n
        still = ref[n] == old[n]
        assert torch.equal(new[n][still], old[n][still]), f"{what} {n}"


def check_mu(opt, names, ref_mu, what, tol):
    """Adam's first moment (1 - b1) * clipped g, fp32: per tensor, max error
    within ``tol`` of the tensor's largest element (fp32 gradients summed in
    another order)."""
    for n, m in zip(names, opt.mu):
        assert m.dtype == torch.float32, n
        r = ref_mu[n].numpy()
        err = float(np.abs(m.numpy() - r).max())
        assert err <= tol * float(np.abs(r).max()) + 1e-12, (what, n, err)


@pytest.mark.parametrize("latent", ["vae", "vq"])
@pytest.mark.parametrize("adv_on", [False, True])
def test_train_step_matches_jax_make_train_step(latent, adv_on):
    """One step: the five losses, the generator's and the discriminator's
    params after their updates and Adam's first moment of both."""
    cfg = ae_config()
    tr, g_state, d_state, port = jax_and_port(cfg, latent, seed=101 if latent == "vae" else 111)
    initial = compute_initial_patch_size(cfg["ae_transformations"])
    x = np.random.default_rng(102).uniform(0, 1, (2, *initial, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(103)
    aug_rng, samp_rng, _ = jax.random.split(rng, 3)
    eps = None
    if latent == "vae":
        eps = torch.from_numpy(np.array(jax.random.normal(samp_rng, (2, 16, 16, 16, 4),
                                                          jnp.float32)))
    draws = AEDraws(jax_draws(aug_rng, 2, 1, tr.aug_cfg), eps)
    g_old = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    d_old = {n: p.detach().clone() for n, p in port.discriminator.named_parameters()}

    g_state, d_state, jm = tr._make_train_step(adv_on)(g_state, d_state, jnp.asarray(x), rng)
    m = port.train_step(torch.from_numpy(x), adv_on, draws=draws)
    for k in ("rec", "perc", "reg", "gen_adv", "disc"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-9, err_msg=k)
    assert (float(jm["gen_adv"]) > 0) == adv_on and (float(jm["disc"]) > 0) == adv_on

    g_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, g_state.params))
    g_new = {n: p.detach() for n, p in port.model.named_parameters()}
    g_mu = jax_mu(g_state)
    check_first_adam_update(g_old, g_new, g_ref, g_mu, port.g_names, "generator")
    check_mu(port.g_opt, port.g_names, g_mu, "generator", 1e-3)
    assert port.g_opt.count == 1 and port.step == 1
    d_new = {n: p.detach() for n, p in port.discriminator.named_parameters()}
    if adv_on:
        d_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, d_state.params))
        d_mu = jax_mu(d_state)
        check_first_adam_update(d_old, d_new, d_ref, d_mu, port.d_names, "discriminator")
        # the discriminator's input, the reconstruction, already differs by
        # fp32 noise, and its first conv's bias gradient sums every position
        # of the patch grid with cancellation (read: 1.3e-3 of its largest)
        check_mu(port.d_opt, port.d_names, d_mu, "discriminator", 5e-3)
        assert port.d_opt.count == 1 == int(d_state.opt_state[1][0].count)
    else:
        assert all(torch.equal(d_new[n], d_old[n]) for n in d_old)
        assert port.d_opt.count == 0 == int(d_state.opt_state[1][0].count)


def test_nnunet_train_step_with_every_augmentation_matches_jax():
    """One KL-VAE step with the adversarial loss under the nnunet preset
    with noise, elastic, blur and low resolution on (rotation about all three
    axes from the (79, 80, 78) initial patch), against the JAX step fed the
    same keys: a key at which the 3D rotation, noise, elastic, blur and low
    resolution each run on one of the two samples. The losses, and the
    generator's and the discriminator's params and first moments as the
    test above holds them."""
    from test_torch_augment import ALL_ON

    cfg = ae_config()
    cfg["ae_transformations"] = dict(cfg["ae_transformations"], aug_preset="nnunet", **ALL_ON)
    tr, g_state, d_state, port = jax_and_port(cfg, "vae", seed=131)
    initial = compute_initial_patch_size(cfg["ae_transformations"])
    assert tuple(initial) == (79, 80, 78) and tr.aug_cfg.rot_3d
    x = np.random.default_rng(132).uniform(0, 1, (2, *initial, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(222)
    aug_rng, samp_rng, _ = jax.random.split(rng, 3)
    d = jax_draws(aug_rng, 2, 1, tr.aug_cfg)
    assert all(bool(c.any()) for c in (d.rot_on, d.noise_on, d.elastic_on, d.blur_on,
                                        d.lowres_on & d.lowres_chan_on[:, 0]))
    eps = torch.from_numpy(np.array(jax.random.normal(samp_rng, (2, 16, 16, 16, 4),
                                                      jnp.float32)))
    g_old = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    d_old = {n: p.detach().clone() for n, p in port.discriminator.named_parameters()}
    g_state, d_state, jm = tr._make_train_step(True)(g_state, d_state, jnp.asarray(x), rng)
    m = port.train_step(torch.from_numpy(x), True, draws=AEDraws(d, eps))
    for k in ("rec", "perc", "reg", "gen_adv", "disc"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-9, err_msg=k)
    g_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, g_state.params))
    g_new = {n: p.detach() for n, p in port.model.named_parameters()}
    g_mu = jax_mu(g_state)
    check_first_adam_update(g_old, g_new, g_ref, g_mu, port.g_names, "generator")
    check_mu(port.g_opt, port.g_names, g_mu, "generator", 1e-3)
    d_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, d_state.params))
    d_new = {n: p.detach() for n, p in port.discriminator.named_parameters()}
    d_mu = jax_mu(d_state)
    check_first_adam_update(d_old, d_new, d_ref, d_mu, port.d_names, "discriminator")
    check_mu(port.d_opt, port.d_names, d_mu, "discriminator", 5e-3)


def test_adapt_kl_loss_weight_matches_jax(monkeypatch):
    """kl_weight: auto -> 0.001 / 10^floor(log10(mean KL)) over the
    validation batches, the same value as the JAX trainer's."""
    cfg = ae_config(kl_weight="auto")
    tr, g_state, _, port = jax_and_port(cfg, "vae", seed=121)
    assert port.auto_kl_weight and tr.auto_kl_weight
    monkeypatch.setattr(jtrain_ae, "put_batch", lambda batch, mesh: batch)
    tr.mesh = None
    val = [np.random.default_rng(122 + i).uniform(0, 1, (2, 32, 32, 32, 1)).astype(np.float32)
           for i in range(2)]
    tr.kl_weight = port.kl_weight = 0.5  # so that an update shows
    tr.adapt_kl_loss_weight(g_state, val)
    port.adapt_kl_loss_weight(val)
    assert port.kl_weight == tr.kl_weight != 0.5
    pinned = ae_config(kl_weight=3e-5)
    _, _, _, p2 = jax_and_port(pinned, "vae", seed=123)
    p2.adapt_kl_loss_weight(val)
    assert p2.kl_weight == 3e-5


@pytest.mark.parametrize("kw,want", [("auto", (True, 1e-6)), ("AUTO", (True, 1e-6)),
                                     ("2e-5", (False, 2e-5)), (None, (False, 1e-6)),
                                     (1e-7, (False, 1e-7))])
def test_parse_kl_weight_equals_jax(kw, want):
    assert ttrain_ae.parse_kl_weight(kw) == jtrain_ae.parse_kl_weight(kw) == want


@pytest.mark.parametrize("latent", ["vae", "vq"])
@pytest.mark.parametrize("with_vqvae_params", [False, True])
def test_filter_config_train_autoencoder_equals_jax(latent, with_vqvae_params):
    """The train_autoencoder branch of filter_config_by_mode, with and
    without an explicit vqvae_params (which drops vae_params for vq)."""
    cfg = ae_config(latent_space_type=latent, load_autoencoder_path="x")
    if with_vqvae_params:
        cfg["vqvae_params"] = dict(cfg["vae_params"], num_embeddings=64, embedding_dim=4)
    t = trun.filter_config_by_mode(copy.deepcopy(cfg), "train_autoencoder")
    assert t == jrun.filter_config_by_mode(copy.deepcopy(cfg), "train_autoencoder")
    assert "ddpm_params" not in t and "load_autoencoder_path" not in t
    assert ("vae_params" in t) == (latent == "vae" or not with_vqvae_params)
    assert ("kl_weight" in t) == (latent == "vae")
    gp = tcommon.generator_params(t, latent)
    assert gp.get("embedding_dim", 8) == (4 if latent == "vq" and with_vqvae_params else 8)
