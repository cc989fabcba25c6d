"""PyTorch port, augmentation: ``augment_batch`` against the JAX package's
``augment_batch`` on an enlarged input with ``crop_to``, fed the JAX
function's own random numbers (derived from its keys exactly as
``_augment_one`` does: ``split(rng, B)``, then ``split(key, 22)``), and the
config / geometry copies against the JAX ones. fp32 on the CPU."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.data import augment as jaug
from medical_image_generation_tpu.data import patches as jpatches
from medical_image_generation_tpu.planning import planner as jplanner
from medical_image_generation_tpu_torch.data import augment as taug
from medical_image_generation_tpu_torch.data import patches as tpatches
from medical_image_generation_tpu_torch.planning import planner as tplanner

# fp32 on both sides; the bilinear weights and the intensity statistics
# differ by summation order and by XLA's fused arithmetic
AUG_TOL = dict(rtol=1e-5, atol=1e-5)


def jax_draws(rng, batch: int, channels: int, cfg) -> taug.AugmentDraws:
    """The draws ``_augment_one`` makes from ``rng`` (augment.py:369-510)."""
    keys = [jax.random.split(k, 22) for k in jax.random.split(rng, batch)]

    def stack(fn):
        return torch.stack([torch.from_numpy(np.array(fn(k))) for k in keys])

    def u(key, *shape, lo=0.0, hi=1.0):
        return jax.random.uniform(key, shape, minval=lo, maxval=hi)

    rr = float(cfg.rot_range)
    n_axes = len(cfg.mirror_axes) if cfg.mirror_axes is not None else 1
    rot = cfg.rotation and cfg.rot_range > 0
    return taug.AugmentDraws(
        rot_on=stack(lambda k: u(k[0]) < jaug.P_ROT if rot else jnp.array(False)),
        scale_on=stack(lambda k: u(k[1]) < jaug.P_SCALE if cfg.scaling else jnp.array(False)),
        angle=stack(lambda k: u(k[2], lo=-rr, hi=rr)),
        scale=stack(lambda k: u(k[3], lo=cfg.scale_range[0], hi=cfg.scale_range[1])),
        flips=stack(lambda k: u(k[4], n_axes) < 0.5),
        bright_on=stack(lambda k: u(k[10]) < jaug.P_BRIGHT),
        bright=stack(lambda k: u(k[11], channels, lo=cfg.bright_range[0],
                                 hi=cfg.bright_range[1])),
        contrast_on=stack(lambda k: u(k[12]) < jaug.P_CONTRAST),
        contrast=stack(lambda k: u(k[13], channels, lo=cfg.contrast_range[0],
                                   hi=cfg.contrast_range[1])),
        gamma_on=stack(lambda k: u(k[14]) < jaug.P_GAMMA),
        gamma=stack(lambda k: u(k[15], channels, lo=cfg.gamma_range[0],
                                hi=cfg.gamma_range[1])))


def _flagship_transformations():
    vae, ddpm, _ = tplanner.flagship_configs(tiny=True)
    ds = {"median_shape": (16, 16, 16), "max_shape": (16, 16, 16)}
    return tplanner.create_config_dict(ds, [0], 1, vae, ddpm)


def _configs(transformations, **over):
    j = jaug.AugmentConfig.from_transformations(transformations, spatial_dims=3)._replace(**over)
    t = taug.AugmentConfig.from_transformations(transformations, spatial_dims=3)
    return j, replace(t, **over) if over else t


@pytest.mark.parametrize("force_scale", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_batch_matches_jax(seed, force_scale):
    """The flagship ``ddpm_transformations`` (rotation off, scaling on) on
    the enlarged loader patch; ``force_scale`` sets P_SCALE's coin on for
    every sample so the resample path always runs."""
    t = _flagship_transformations()["ddpm_transformations"]
    jcfg, tcfg = _configs(t)
    initial = tpatches.compute_initial_patch_size(t)
    x = np.random.default_rng(seed).uniform(0, 1, (3, *initial, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(100 + seed)
    draws = jax_draws(rng, 3, 1, jcfg)
    if force_scale:
        # the JAX coin is uniform < P_SCALE; with P_SCALE raised to 1 every
        # sample resamples, and the scale value comes from the same key
        draws = draws._replace(scale_on=torch.ones(3, dtype=torch.bool))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jaug, "P_SCALE", 1.0)
            ref = np.asarray(jax.vmap(lambda a, r: jaug._augment_one(a, r, jcfg))(
                jnp.asarray(x), jax.random.split(rng, 3)))
    else:
        ref = np.asarray(jaug.augment_batch(jnp.asarray(x), rng, jcfg))
    got = taug.augment_batch(torch.from_numpy(x), draws, tcfg).numpy()
    assert got.shape == ref.shape == (3, *t["patch_size"], 1)
    np.testing.assert_allclose(got, ref, **AUG_TOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_rotation_and_two_channels_match_jax(seed):
    """Plane rotation with scaling (the AE's transformations), two channels,
    each coin forced on through the JAX probabilities."""
    t = _flagship_transformations()["ae_transformations"]
    jcfg, tcfg = _configs(t)
    initial = tpatches.compute_initial_patch_size(t)
    x = np.random.default_rng(seed).uniform(0, 1, (2, *initial, 2)).astype(np.float32)
    rng = jax.random.PRNGKey(seed)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("P_ROT", "P_SCALE", "P_BRIGHT", "P_CONTRAST", "P_GAMMA"):
            mp.setattr(jaug, name, 1.0)
        ref = np.asarray(jax.vmap(lambda a, r: jaug._augment_one(a, r, jcfg))(
            jnp.asarray(x), jax.random.split(rng, 2)))
        draws = jax_draws(rng, 2, 2, jcfg)
    assert bool(draws.rot_on.all() and draws.gamma_on.all())
    got = taug.augment_batch(torch.from_numpy(x), draws, tcfg).numpy()
    np.testing.assert_allclose(got, ref, **AUG_TOL)


def test_config_and_geometry_copies_equal_jax():
    cfg = _flagship_transformations()
    ds = {"median_shape": (16, 16, 16), "max_shape": (16, 16, 16)}
    vae, ddpm, _ = tplanner.flagship_configs(tiny=True)
    assert cfg == jplanner.create_config_dict(ds, [0], 1, vae, ddpm)
    for key in ("ddpm_transformations", "ae_transformations"):
        t = cfg[key]
        assert tpatches.spatial_aug_params(t) == jpatches.spatial_aug_params(t)
        j = jaug.AugmentConfig.from_transformations(t, spatial_dims=3)
        tc = taug.AugmentConfig.from_transformations(t, spatial_dims=3)
        assert {f: getattr(tc, f) for f in j._fields} == j._asdict()
    nn = dict(cfg["ae_transformations"], aug_preset="nnunet")
    assert tpatches.spatial_aug_params(nn) == jpatches.spatial_aug_params(nn)


def test_unported_transforms_raise_and_draws_have_the_jax_distributions():
    x = torch.rand((2, 8, 10, 10, 1))
    cfg = taug.AugmentConfig(crop_to=(8, 8, 8))
    d = taug.make_draws(cfg, 2, 1, 3, torch.Generator().manual_seed(0))
    assert d.bright.shape == (2, 1) and d.flips.shape == (2, 1)
    assert taug.augment_batch(x, d, cfg).shape == (2, 8, 8, 8, 1)
    for bad in (dict(gaussian_noise=True), dict(gaussian_blur=True), dict(elastic=True),
                dict(low_resolution=True), dict(rot_3d=True)):
        with pytest.raises(NotImplementedError):
            taug.augment_batch(x, d, replace(cfg, **bad))
    many = taug.make_draws(cfg, 20000, 1, 3, torch.Generator().manual_seed(1))
    assert abs(many.scale_on.float().mean().item() - taug.P_SCALE) < 0.02
    assert 0.9 <= many.scale.min().item() and many.scale.max().item() <= 1.1
