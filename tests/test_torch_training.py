"""PyTorch port, training: U-Net gradients and the VAE encode against the
flax modules, one whole port ``train_step`` against the shipped JAX
``LDMTrainer._make_train_step`` fed the same random numbers, and
train -> save -> sample through the sampling CLI. fp32 on the CPU, tiny 3D
config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from medical_image_generation_tpu.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from medical_image_generation_tpu.training import common as jcommon
from medical_image_generation_tpu.training.train_ldm import LDMTrainer as JLDMTrainer
from medical_image_generation_tpu_torch import _device
from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
from medical_image_generation_tpu_torch.planning import planner as tplanner
from medical_image_generation_tpu_torch.training import sample as tsample
from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer, TrainDraws
from test_torch_augment import jax_draws
from torch_parity import nd, tiny_unet_pair, tiny_vae_pair

LR = 2e-5


def _config(**over):
    vae, ddpm, _ = tplanner.flagship_configs(tiny=True)
    ds = {"median_shape": (16, 16, 16), "max_shape": (16, 16, 16)}
    cfg = tplanner.create_config_dict(ds, [0], 1, vae, ddpm)
    cfg["time_scheduler_params"] = dict(cfg["time_scheduler_params"], num_train_timesteps=50)
    cfg.update(over)
    return cfg


def test_unet_gradients_match_jax_grad():
    """MSE loss through the tiny U-Net: every parameter's gradient against
    jax.grad through the flax module. fp32; reductions over the 16^3 grid
    in another order than XLA."""
    jm, params, tm, latent, ddpm_p = tiny_unet_pair(seed=21)
    x = nd((2, *latent, ddpm_p["in_channels"]), 22)
    target = nd(x.shape, 23)
    t = np.array([3, 41], np.int32)

    def loss_fn(p):
        pred = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean((pred - jnp.asarray(target)) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    from medical_image_generation_tpu_torch import convert

    ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jg))
    tm.train()
    loss = torch.mean((tm(torch.from_numpy(x), torch.from_numpy(t).long())
                       - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name].grad
        assert g is not None, name
        scale = float(np.abs(r.numpy()).max()) + 1e-12
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=name)


def test_vae_encode_matches_jax():
    jm, params, tm, vae_p = tiny_vae_pair(seed=24)
    x = np.random.default_rng(25).uniform(0, 1, (2, 32, 32, 32, 1)).astype(np.float32)
    jmu, jsig = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        mu, sig = tm.encode(torch.from_numpy(x))
    assert mu.shape == (2, 16, 16, 16, vae_p["latent_channels"])
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), rtol=1e-4, atol=1e-4)
    eps = nd(mu.shape, 26)
    z = tm.encode_stage_2_inputs(torch.from_numpy(x), torch.from_numpy(eps))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jmu) + np.asarray(jsig) * eps,
                               rtol=1e-4, atol=1e-4)


def _jax_trainer(cfg, jm, uparams, jvae, vparams, scale, class_cond):
    """A JAX LDMTrainer carrying what ``_make_train_step`` reads (no
    checkpoint on disk, no loader)."""
    tr = object.__new__(JLDMTrainer)
    tr.config = cfg
    tr.unet, tr.autoencoder, tr.ae_params = jm, jvae, vparams
    tr.schedule = JNoiseSchedule.from_config(cfg["time_scheduler_params"])
    tr.latent_space_type = "vae"
    tr.scale_factor = scale
    tr.aug_cfg = _jax_aug_cfg(cfg)
    tr.ema_decay = cfg.get("ema_decay")
    tr.clip = 1.0
    tr.class_cond = class_cond
    if class_cond:
        tr.num_classes = class_cond["num_classes"]
        tr.cfg_dropout = class_cond["dropout_prob"]
    tx = jcommon.make_optimizer(jcommon.make_lr_schedule(LR, None, None, 250), 1.0, 1,
                                weight_decay=1e-2,
                                mu_dtype=jcommon.mu_dtype_from_config(cfg))
    kw = dict(apply_fn=jm.apply, params=uparams, tx=tx)
    if tr.ema_decay:
        state = jcommon.EMATrainState.create(
            ema_params=jax.tree_util.tree_map(jnp.copy, uparams), **kw)
    else:
        state = jcommon.TrainState.create(**kw)
    return tr, tr.aug_cfg, state


def _jax_aug_cfg(cfg):
    from medical_image_generation_tpu.data.augment import AugmentConfig

    return AugmentConfig.from_transformations(cfg["ddpm_transformations"], spatial_dims=3)


@pytest.mark.parametrize("class_cond,ema", [(False, None), (True, 0.9)])
def test_train_step_matches_jax_make_train_step(class_cond, ema):
    """One port train_step against the shipped JAX step, from the same
    weights and the same random numbers (split as train_ldm.py:229).

    Params after the update: Adam's first update is
    -lr * (g / (|g| + eps) + wd * p), so u = (p_old - p_new) / lr - wd * p_old
    is g / (|g| + eps), about sign(g). Where the JAX |u| > 0.99 (|g| above
    ~1e-6) the port's u agrees to 1e-3 (fp32 gradients in another summation
    order). Where |g| is near eps the sign and size of u hang on rounding;
    there the test only asks |u| <= 1, for at most 1% of the elements."""
    cc = {"num_classes": 3, "dropout_prob": 0.5} if class_cond else None
    cfg = _config(ema_decay=ema, class_conditioning=cc)
    jm, uparams, tm_ref, latent, ddpm_p = tiny_unet_pair(4 if class_cond else None, seed=31)
    jvae, vparams, tvae, _ = tiny_vae_pair(seed=32)
    scale = 0.7
    tr, jcfg, state = _jax_trainer(cfg, jm, uparams, jvae, vparams, scale, cc)
    initial = compute_initial_patch_size(cfg["ddpm_transformations"])
    x = np.random.default_rng(33).uniform(0, 1, (2, *initial, 1)).astype(np.float32)
    labels = np.array([2, 0], np.int32) if class_cond else None
    rng = jax.random.PRNGKey(34)

    trainer = LDMTrainer(cfg, tm_ref, tvae, device="cpu")
    trainer.scale_factor = scale
    p_old = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()}

    aug_rng, enc_rng, t_rng, n_rng, d_rng = jax.random.split(rng, 5)
    lat = (2, *latent, ddpm_p["in_channels"])
    draws = TrainDraws(
        augment=jax_draws(aug_rng, 2, 1, jcfg),
        eps=torch.from_numpy(np.array(jax.random.normal(enc_rng, lat, jnp.float32))),
        t=torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 50))).long(),
        noise=torch.from_numpy(np.array(jax.random.normal(n_rng, lat, jnp.float32))),
        drop=(torch.from_numpy(np.array(jax.random.uniform(d_rng, (2,)) < 0.5))
              if class_cond else None))
    batch = {"image": jnp.asarray(x), "class": jnp.asarray(labels)} if class_cond \
        else jnp.asarray(x)
    state, jloss = tr._make_train_step()(state, vparams, batch, rng)
    loss = trainer.train_step(torch.from_numpy(x),
                              torch.from_numpy(labels).long() if class_cond else None,
                              draws=draws)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)

    from medical_image_generation_tpu_torch import convert

    new_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    n_off, n_all = 0, 0
    for name, p in trainer.unet.named_parameters():
        old = p_old[name]
        u_j = (old - new_ref[name]) / LR - 1e-2 * old
        u_t = (old - p.detach()) / LR - 1e-2 * old
        firm = u_j.abs() > 0.99
        np.testing.assert_allclose(u_t[firm].numpy(), u_j[firm].numpy(), rtol=0, atol=1e-3,
                                   err_msg=name)
        # |g / (|g| + eps)| <= 1, up to the fp32 rounding of p_new (one ulp of p over lr)
        assert bool((u_t.abs() <= 1.0 + 2.0 ** -22 * old.abs() / LR + 1e-6).all()), name
        n_off += int((~firm).sum())
        n_all += firm.numel()
    assert n_off <= 0.01 * n_all, (n_off, n_all)
    assert trainer.opt.mu[0].dtype == torch.bfloat16
    if ema:
        ema_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    state.ema_params))
        sd = trainer.unet_state_for_sampling()
        # ema = decay * p_old + (1 - decay) * p_new: the new params differ by
        # at most 2 lr (elements with |g| near eps), plus two fp32 ulps of p
        for name in ema_ref:
            np.testing.assert_allclose(sd[name].numpy(), ema_ref[name].numpy(), rtol=2.0 ** -22,
                                       atol=2.02 * LR * (1 - ema), err_msg=name)


def test_train_save_sample_roundtrip(tmp_path):
    """LDMTrainer.from_config -> probe_latent -> two train steps -> val_step
    -> save_checkpoint -> the sampling CLI writes finite volumes."""
    cfg = _config()
    _, _, tvae, vae_p = tiny_vae_pair(seed=41)
    trainer = LDMTrainer.from_config(cfg, tvae.state_dict(), device="cpu",
                                     dtype=torch.float32, seed=3)
    initial = compute_initial_patch_size(cfg["ddpm_transformations"])
    x = torch.rand((2, *initial, 1), generator=torch.Generator().manual_seed(0))
    sf, shape = trainer.probe_latent(x)
    assert shape == (2, 16, 16, 16, 4) and np.isfinite(sf)
    before = [p.detach().clone() for p in trainer.params]
    losses = [float(trainer.train_step(x)) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert all(not torch.equal(a, p) for a, p in zip(before, trainer.params)
               if p.grad is not None and p.grad.abs().sum() > 0)
    val = trainer.val_step(x[:, :, :32, :32])
    assert np.isfinite(float(val))
    ckpt = tmp_path / "ldm.pt"
    trainer.save_checkpoint(str(ckpt))
    conf = tmp_path / "config.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "samples"
    tsample.main_ldm([str(conf), str(ckpt), "-n", "1", "--num_inference_steps", "2",
                      "--dtype", "fp32", "--device", "cpu", "-o", str(out)])
    v = np.load(out / "ldm_sample_000.npy")
    assert v.shape == (32, 32, 32, 1) and np.isfinite(v).all()


def test_trainer_refuses_cpu_fallback_and_accumulation(monkeypatch):
    cfg = _config()
    _, _, tvae, _ = tiny_vae_pair(seed=42)
    with pytest.raises(NotImplementedError, match="grad_accumulate_step"):
        LDMTrainer.from_config(dict(cfg, grad_accumulate_step=2), tvae.state_dict(),
                               device="cpu", dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LDMTrainer.from_config(cfg, tvae.state_dict())
    assert _device.resolve_device("cpu") == torch.device("cpu")
