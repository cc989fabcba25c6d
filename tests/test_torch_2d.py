"""PyTorch port, the planner's 2D configuration: the 2D config dicts
against the JAX planner's; the tiny 2D U-Net (forward and gradients), the
KL-VAE's encode and decode, the 2D PatchDiscriminator and the plain 2D VGG
perceptual loss against the flax modules; 2D augmentation fed the JAX
function's own draws; one 2D LDM ``train_step`` against
``LDMTrainer._make_train_step`` and one 2D AE step against
``AutoEncoderTrainer._make_train_step(adv_on)``. fp32 on the CPU, tiny 2D
config (32^2 images, 16^2 latents), at the tolerances of the 3D tests
they mirror."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.data import augment as jaug
from medical_image_generation_tpu.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from medical_image_generation_tpu.models import discriminator as jdisc
from medical_image_generation_tpu.models import perceptual as jperc
from medical_image_generation_tpu.planning import planner as jplanner
from medical_image_generation_tpu.training import common as jcommon
from medical_image_generation_tpu.training.train_ldm import LDMTrainer as JLDMTrainer
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.data import augment as taug
from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
from medical_image_generation_tpu_torch.models import discriminator as tdisc
from medical_image_generation_tpu_torch.models import perceptual as tperc
from medical_image_generation_tpu_torch.planning import planner as tplanner
from medical_image_generation_tpu_torch.training.train_autoencoder import AEDraws
from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer, TrainDraws
from test_torch_augment import AUG_TOL, jax_draws
from test_torch_autoencoder import OUT_TOL, grad_close
from test_torch_train_ae import check_first_adam_update, check_mu, jax_and_port, jax_mu
from torch_parity import init_shapes, nd, rand_params, tiny_unet_pair, tiny_vae_pair

LR = 2e-5


def config_2d(tiny=True, **over):
    """The planner's 2D config dict (tiny: 32^2 patch), 50 timesteps."""
    vae, ddpm, _ = tplanner.flagship_configs(tiny=tiny, spatial_dims=2)
    cfg = tplanner.create_config_dict(tplanner.flagship_dataset(tiny, 2), [0], 1, vae, ddpm)
    cfg["time_scheduler_params"] = dict(cfg["time_scheduler_params"], num_train_timesteps=50)
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("tiny", [True, False])
def test_2d_config_dict_equals_jax(tiny):
    """The flagship 2D plan (dataset (128, 256, 256)) and its tiny shrink,
    through both packages' ``create_*_dict`` / ``create_config_dict``."""
    ds = tplanner.flagship_dataset(tiny, 2)
    vae, ddpm, image = tplanner.flagship_configs(tiny=tiny, spatial_dims=2)
    if not tiny:
        assert vae == jplanner.create_autoencoder_dict(ds, [0], spatial_dims=2)
        assert ddpm == jplanner.create_ddpm_dict(ds, spatial_dims=2)
        assert image == [256, 256] and vae["num_channels"] == [64, 128, 256]
        assert ddpm["strides"] == [[1, 1], [2, 2], [2, 2]]
    cfg = tplanner.create_config_dict(ds, [0], 1, vae, ddpm)
    assert cfg == jplanner.create_config_dict(ds, [0], 1, vae, ddpm)
    assert (cfg["ae_batch_size"], cfg["ddpm_batch_size"]) == (24, 48)
    assert (cfg["perc_weight"], cfg["kl_weight"], cfg["n_epochs"]) == (0.5, 1e-6, 200)
    assert cfg["perceptual_params"] == {"spatial_dims": 2, "network_type": "vgg"}


def test_tiny_2d_unet_matches_flax():
    jm, params, tm, latent, ddpm_p = tiny_unet_pair(seed=201, spatial_dims=2)
    x = nd((2, *latent, ddpm_p["in_channels"]), 202)
    t = np.array([5, 977], np.int32)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_2d_unet_gradients_match_jax_grad():
    """Every parameter's gradient of an MSE loss through the tiny 2D U-Net,
    against jax.grad (the 3D test's tolerance)."""
    jm, params, tm, latent, ddpm_p = tiny_unet_pair(seed=203, spatial_dims=2)
    x = nd((2, *latent, ddpm_p["in_channels"]), 204)
    target = nd(x.shape, 205)
    t = np.array([3, 41], np.int32)

    def loss_fn(p):
        pred = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean((pred - jnp.asarray(target)) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jg))
    tm.train()
    loss = torch.mean((tm(torch.from_numpy(x), torch.from_numpy(t).long())
                       - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for name, r in ref.items():
        scale = float(np.abs(r.numpy()).max()) + 1e-12
        np.testing.assert_allclose(got[name].grad.numpy(), r.numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


def test_tiny_2d_vae_encode_decode_match_flax():
    jm, params, tm, vae_p = tiny_vae_pair(seed=206, spatial_dims=2)
    x = np.random.default_rng(207).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    jmu, jsig = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        mu, sig = tm.encode(torch.from_numpy(x))
    assert mu.shape == (2, 16, 16, vae_p["latent_channels"])
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), rtol=1e-4, atol=1e-4)
    z = nd(mu.shape, 208)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(z), method=jm.decode))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_2d_discriminator_matches_jax():
    """The planner's 2D PatchDiscriminator (4^2 convs, one-channel-a-group
    instance norms), logits and the gradient of the generator's LSGAN loss
    to its input."""
    p = dict(config_2d()["discriminator_params"], num_channels=8)
    jm = jdisc.PatchDiscriminator.from_config(p, dtype=jnp.float32)
    x = np.random.default_rng(209).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), jnp.asarray(x)), 210)
    tm = tdisc.PatchDiscriminator.from_config(p, dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.vae_from_flax(params))

    def gen_loss(img):
        return jdisc.least_squares_gan_loss(logits_fake=jm.apply({"params": params}, img))

    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    jl, jgx = jax.value_and_grad(gen_loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    logits = tm(xt)
    loss = tdisc.least_squares_gan_loss(logits_fake=logits)
    loss.backward()
    assert logits.shape == ref.shape == (2, 6, 6, 1)
    np.testing.assert_allclose(logits.detach().numpy(), ref, **OUT_TOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    grad_close(xt.grad.numpy(), np.asarray(jgx), "d loss / d x")


def test_2d_perceptual_loss_and_gradient_match_jax():
    """The 2D planner's perceptual loss (plain 2D VGG, no fake-3D slices)
    from ``from_config``, and its gradient to the prediction."""
    pp = dict(config_2d()["perceptual_params"], feature_plan=[[8, 1], [16, 2]])
    jp = jperc.PerceptualLoss.from_config(pp, dtype=jnp.float32)
    tp = tperc.PerceptualLoss.from_config(pp, dtype=torch.float32, device="cpu")
    tp.module.load_state_dict(convert.perceptual_from_flax(jax.device_get(jp.params)))
    rng = np.random.default_rng(211)
    pred, target = (rng.uniform(0, 1, (3, 32, 32, 1)).astype(np.float32) for _ in range(2))
    jl, jg = jax.value_and_grad(lambda a: jp(a, jnp.asarray(target)))(jnp.asarray(pred))
    pt = torch.from_numpy(pred).requires_grad_()
    loss = tp(pt, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    grad_close(pt.grad.numpy(), np.asarray(jg), "d perc / d pred")


@pytest.mark.parametrize("key", ["ae_transformations", "ddpm_transformations"])
@pytest.mark.parametrize("seed", [0, 1])
def test_2d_augment_batch_matches_jax(key, seed):
    """In-plane rotation (AE) and scaling with the enlarged patch, mirror,
    brightness, contrast and gamma on 2D batches, every coin forced on
    through the JAX probabilities, fed the JAX function's own draws."""
    t = config_2d()[key]
    jcfg = jaug.AugmentConfig.from_transformations(t, spatial_dims=2)
    tcfg = taug.AugmentConfig.from_transformations(t, spatial_dims=2)
    initial = compute_initial_patch_size(t)
    assert len(initial) == 2
    x = np.random.default_rng(212 + seed).uniform(0, 1, (3, *initial, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(300 + seed)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("P_ROT", "P_SCALE", "P_BRIGHT", "P_CONTRAST", "P_GAMMA"):
            mp.setattr(jaug, name, 1.0)
        ref = np.asarray(jax.vmap(lambda a, r: jaug._augment_one(a, r, jcfg))(
            jnp.asarray(x), jax.random.split(rng, 3)))
        draws = jax_draws(rng, 3, 1, jcfg)
    assert bool(draws.scale_on.all()) and bool(draws.rot_on.all()) == (key == "ae_transformations")
    got = taug.augment_batch(torch.from_numpy(x), draws, tcfg).numpy()
    assert got.shape == ref.shape == (3, 32, 32, 1)
    np.testing.assert_allclose(got, ref, **AUG_TOL)


def _jax_ldm_trainer(cfg, jm, uparams, jvae, vparams, scale):
    tr = object.__new__(JLDMTrainer)
    tr.config = cfg
    tr.unet, tr.autoencoder, tr.ae_params = jm, jvae, vparams
    tr.schedule = JNoiseSchedule.from_config(cfg["time_scheduler_params"])
    tr.latent_space_type = "vae"
    tr.scale_factor = scale
    tr.aug_cfg = jaug.AugmentConfig.from_transformations(cfg["ddpm_transformations"],
                                                         spatial_dims=2)
    tr.ema_decay, tr.clip, tr.class_cond = None, 1.0, None
    tx = jcommon.make_optimizer(jcommon.make_lr_schedule(LR, None, None, 250), 1.0, 1,
                                weight_decay=1e-2, mu_dtype=jcommon.mu_dtype_from_config(cfg))
    return tr, jcommon.TrainState.create(apply_fn=jm.apply, params=uparams, tx=tx)


def test_2d_ldm_train_step_matches_jax_make_train_step():
    """One 2D port train_step against the JAX step from the same weights and
    random numbers; Adam's first update held as in the 3D test."""
    cfg = config_2d()
    jm, uparams, tm_ref, latent, ddpm_p = tiny_unet_pair(seed=221, spatial_dims=2)
    jvae, vparams, tvae, _ = tiny_vae_pair(seed=222, spatial_dims=2)
    tr, state = _jax_ldm_trainer(cfg, jm, uparams, jvae, vparams, 0.7)
    initial = compute_initial_patch_size(cfg["ddpm_transformations"])
    x = np.random.default_rng(223).uniform(0, 1, (3, *initial, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(224)
    trainer = LDMTrainer(cfg, tm_ref, tvae, device="cpu")
    trainer.scale_factor = 0.7
    p_old = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()}
    aug_rng, enc_rng, t_rng, n_rng, _ = jax.random.split(rng, 5)
    lat = (3, *latent, ddpm_p["in_channels"])
    draws = TrainDraws(
        augment=jax_draws(aug_rng, 3, 1, tr.aug_cfg),
        eps=torch.from_numpy(np.array(jax.random.normal(enc_rng, lat, jnp.float32))),
        t=torch.from_numpy(np.array(jax.random.randint(t_rng, (3,), 0, 50))).long(),
        noise=torch.from_numpy(np.array(jax.random.normal(n_rng, lat, jnp.float32))))
    state, jloss = tr._make_train_step()(state, vparams, jnp.asarray(x), rng)
    loss = trainer.train_step(torch.from_numpy(x), draws=draws)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    new_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    n_off, n_all = 0, 0
    for name, p in trainer.unet.named_parameters():
        old = p_old[name]
        u_j = (old - new_ref[name]) / LR - 1e-2 * old
        u_t = (old - p.detach()) / LR - 1e-2 * old
        firm = u_j.abs() > 0.99
        np.testing.assert_allclose(u_t[firm].numpy(), u_j[firm].numpy(), rtol=0, atol=1e-3,
                                   err_msg=name)
        assert bool((u_t.abs() <= 1.0 + 2.0 ** -22 * old.abs() / LR + 1e-6).all()), name
        n_off += int((~firm).sum())
        n_all += firm.numel()
    assert n_off <= 0.01 * n_all, (n_off, n_all)


@pytest.mark.parametrize("adv_on", [False, True])
def test_2d_ae_train_step_matches_jax_make_train_step(adv_on):
    """One 2D stage-1 step (KL-VAE, plain 2D perceptual loss, 2D
    discriminator) against the JAX step: the five losses, both networks'
    first Adam updates and first moments, at the 3D test's tolerances."""
    cfg = config_2d(kl_weight=1e-4, adv_weight=0.5, q_weight=1.0)
    cfg["discriminator_params"] = dict(cfg["discriminator_params"], num_channels=8)
    cfg["perceptual_params"] = dict(cfg["perceptual_params"], feature_plan=[[8, 1], [16, 1]])
    tr, g_state, d_state, port = jax_and_port(cfg, "vae", seed=231)
    initial = compute_initial_patch_size(cfg["ae_transformations"])
    x = np.random.default_rng(232).uniform(0, 1, (2, *initial, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(233)
    aug_rng, samp_rng, _ = jax.random.split(rng, 3)
    eps = torch.from_numpy(np.array(jax.random.normal(samp_rng, (2, 16, 16, 4), jnp.float32)))
    draws = AEDraws(jax_draws(aug_rng, 2, 1, tr.aug_cfg), eps)
    g_old = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    d_old = {n: p.detach().clone() for n, p in port.discriminator.named_parameters()}
    g_state, d_state, jm = tr._make_train_step(adv_on)(g_state, d_state, jnp.asarray(x), rng)
    m = port.train_step(torch.from_numpy(x), adv_on, draws=draws)
    for k in ("rec", "perc", "reg", "gen_adv", "disc"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-9, err_msg=k)
    assert (float(jm["gen_adv"]) > 0) == adv_on
    g_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, g_state.params))
    g_new = {n: p.detach() for n, p in port.model.named_parameters()}
    g_mu = jax_mu(g_state)
    check_first_adam_update(g_old, g_new, g_ref, g_mu, port.g_names, "generator")
    check_mu(port.g_opt, port.g_names, g_mu, "generator", 1e-3)
    d_new = {n: p.detach() for n, p in port.discriminator.named_parameters()}
    if adv_on:
        d_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, d_state.params))
        d_mu = jax_mu(d_state)
        check_first_adam_update(d_old, d_new, d_ref, d_mu, port.d_names, "discriminator")
        check_mu(port.d_opt, port.d_names, d_mu, "discriminator", 5e-3)
    else:
        assert all(torch.equal(d_new[n], d_old[n]) for n in d_old)
