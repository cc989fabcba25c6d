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


def jax_draws(rng, batch: int, channels: int, cfg, n_spatial: int = 3) -> taug.AugmentDraws:
    """The draws ``_augment_one`` makes from ``rng`` (augment.py:369-510),
    those of the optional transforms where ``cfg`` switches them on (the
    noise field at ``cfg.crop_to``)."""
    keys = [jax.random.split(k, 22) for k in jax.random.split(rng, batch)]

    def stack(fn):
        return torch.stack([torch.from_numpy(np.array(fn(k))) for k in keys])

    def u(key, *shape, lo=0.0, hi=1.0):
        return jax.random.uniform(key, shape, minval=lo, maxval=hi)

    rr = float(cfg.rot_range)
    n_axes = len(cfg.mirror_axes) if cfg.mirror_axes is not None else 1
    rot = cfg.rotation and cfg.rot_range > 0
    extra = {}
    if cfg.rot_3d and n_spatial == 3 and not cfg.dummy_2d:
        extra.update(angles3=stack(lambda k: u(k[20], 3, lo=-rr, hi=rr)))
    if cfg.gaussian_noise:
        extra.update(noise_on=stack(lambda k: u(k[5]) < jaug.P_NOISE),
                     noise_var=stack(lambda k: u(k[6], hi=0.1)),
                     noise=stack(lambda k: jax.random.normal(k[7], (*cfg.crop_to, channels))))
    if cfg.elastic:
        extra.update(elastic_on=stack(lambda k: u(k[16]) < jaug.P_ELASTIC),
                     elastic_mag=stack(lambda k: u(jax.random.split(k[17])[0],
                                                   hi=jaug.ELASTIC_MAX_FRAC)),
                     elastic_field=stack(lambda k: jax.random.normal(
                         jax.random.split(k[17])[1], (2, 4, 4), jnp.float32)))
    if cfg.gaussian_blur:
        extra.update(blur_on=stack(lambda k: u(k[8]) < jaug.P_BLUR),
                     blur_sigma=stack(lambda k: u(k[9], lo=0.5, hi=1.0)))
    if cfg.low_resolution:
        extra.update(lowres_on=stack(lambda k: u(k[18]) < jaug.P_LOWRES),
                     lowres_scale=stack(lambda k: u(jax.random.split(k[19])[0], channels,
                                                    lo=jaug.LOWRES_SCALE[0],
                                                    hi=jaug.LOWRES_SCALE[1])),
                     lowres_chan_on=stack(lambda k: u(jax.random.split(k[19])[1],
                                                      channels) < 0.5))
    return taug.AugmentDraws(**extra,
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


ALL_ON = dict(gaussian_noise=True, gaussian_blur=True, low_resolution=True, elastic=True)


def test_draws_have_the_jax_distributions_and_bad_presets_raise():
    """``make_draws`` with every transform on: the coins' rates, the value
    ranges, the fields' shapes and devices (the scalars from the host
    generator, the fields from ``field_generator``); the draws of a
    transform left off are None. An unknown ``aug_preset`` still raises."""
    x = torch.rand((2, 8, 10, 10, 1))
    cfg = taug.AugmentConfig(crop_to=(8, 8, 8))
    d = taug.make_draws(cfg, 2, 1, 3, torch.Generator().manual_seed(0))
    assert d.bright.shape == (2, 1) and d.flips.shape == (2, 1)
    assert d.noise is None and d.angles3 is None and d.lowres_scale is None
    assert taug.augment_batch(x, d, cfg).shape == (2, 8, 8, 8, 1)
    on = replace(cfg, rot_3d=True, **ALL_ON)
    host, field = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    many = taug.make_draws(on, 20000, 2, 3, host, field)
    for coin, p in (("scale_on", taug.P_SCALE), ("noise_on", taug.P_NOISE),
                    ("elastic_on", taug.P_ELASTIC), ("blur_on", taug.P_BLUR),
                    ("lowres_on", taug.P_LOWRES), ("lowres_chan_on", 0.5)):
        assert abs(getattr(many, coin).float().mean().item() - p) < 0.02, coin
    for name, (lo, hi) in (("scale", (0.9, 1.1)), ("noise_var", (0.0, 0.1)),
                           ("elastic_mag", (0.0, taug.ELASTIC_MAX_FRAC)),
                           ("blur_sigma", (0.5, 1.0)), ("lowres_scale", taug.LOWRES_SCALE),
                           ("angles3", (-on.rot_range, on.rot_range))):
        v = getattr(many, name)
        assert lo <= v.min().item() and v.max().item() <= hi, name
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.02 * (hi - lo), name
    assert many.noise.shape == (20000, 8, 8, 8, 2) and many.lowres_scale.shape == (20000, 2)
    assert many.elastic_field.shape == (20000, 2, 4, 4) and many.angles3.shape == (20000, 3)
    for field_draw in (many.noise, many.elastic_field):
        assert abs(field_draw.mean().item()) < 0.01 and abs(field_draw.std().item() - 1) < 0.01
    # the fields come from field_generator alone: the host draws do not move
    again = taug.make_draws(on, 20000, 2, 3, torch.Generator().manual_seed(1),
                            torch.Generator().manual_seed(3))
    assert torch.equal(again.noise_var, many.noise_var)
    assert not torch.equal(again.noise, many.noise)
    assert taug.augment_batch(x, taug.make_draws(on, 2, 1, 3, host, field), on).shape == \
        (2, 8, 8, 8, 1)
    with pytest.raises(ValueError, match="crop_to"):
        taug.make_draws(replace(on, crop_to=None), 2, 1, 3, host)
    bogus = dict(_flagship_transformations()["ae_transformations"], aug_preset="bogus")
    with pytest.raises(ValueError, match="aug_preset"):
        taug.AugmentConfig.from_transformations(bogus, spatial_dims=3)


def _u(key, *shape, lo=0.0, hi=1.0):
    return np.array(jax.random.uniform(key, shape, minval=lo, maxval=hi))


@pytest.mark.parametrize("transform", ["rot_3d", "elastic", "blur", "lowres", "lowres_dummy_2d"])
def test_new_transforms_match_their_jax_functions(transform):
    """Each optional transform against its JAX private function on the same
    draws: ``_rotate_scale_3d`` (an enlarged input onto a smaller grid),
    ``_elastic_plane``, ``_blur5``, ``_simulate_lowres`` with and without
    ``dummy_2d`` (z left alone)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (11, 14, 13, 2)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    key = jax.random.PRNGKey(11)  # low resolution: channel 1 on, channel 0 off
    if transform == "rot_3d":
        angles = _u(key, 3, lo=-0.52, hi=0.52)
        ref = jaug._rotate_scale_3d(xj, jnp.asarray(angles), jnp.float32(1.13), (8, 9, 10))
        got = taug._rotate_scale_3d(xt, torch.from_numpy(angles), float(np.float32(1.13)),
                                    (8, 9, 10))
    elif transform == "elastic":
        k_mag, k_field = jax.random.split(key)
        mag = _u(k_mag, hi=jaug.ELASTIC_MAX_FRAC)
        field = np.array(jax.random.normal(k_field, (2, 4, 4), jnp.float32))
        ref = jaug._elastic_plane(xj, key)
        got = taug._elastic_plane(xt, float(mag), torch.from_numpy(field))
    elif transform == "blur":
        sigma = _u(key, lo=0.5, hi=1.0)
        ref = jaug._blur5(xj, jnp.asarray(sigma))
        got = taug._blur5(xt, float(sigma))
    else:
        k_s, k_on = jax.random.split(key)
        dummy = transform == "lowres_dummy_2d"
        ref = jaug._simulate_lowres(xj, key, dummy)
        got = taug._simulate_lowres(xt, torch.from_numpy(_u(k_s, 2, lo=0.5, hi=1.0)),
                                    torch.from_numpy(_u(k_on, 2) < 0.5), dummy)
    assert got.shape == ref.shape
    assert not np.allclose(np.asarray(ref), x[tuple(slice(n) for n in ref.shape)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **AUG_TOL)


@pytest.mark.parametrize("hw", [(13, 29), (32, 7)])
def test_elastic_upsample_matches_jax_image_resize(hw):
    """The coarse field's bilinear upsample against ``jax.image.resize``
    itself, at H != W, the edge rows and columns included."""
    field = np.random.default_rng(9).standard_normal((4, 4)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(field), hw, "bilinear"))
    got = taug.resize_bilinear(torch.from_numpy(field), hw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[[0, -1]], ref[[0, -1]], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, [0, -1]], ref[:, [0, -1]], rtol=1e-6, atol=1e-6)


def test_lowres_rounds_half_to_even_as_jnp_round():
    """At scale 0.5 every source position (j + 0.5) / s - 0.5 = 2j + 0.5 is
    an exact half: ``jnp.round`` and the port both round it to even."""
    x = np.random.default_rng(10).uniform(0, 1, (9, 6)).astype(np.float32)
    for ax in (0, 1):
        ref = np.asarray(jaug._axis_lowres(jnp.asarray(x), jnp.float32(0.5), ax))
        np.testing.assert_array_equal(taug._axis_lowres(torch.from_numpy(x), 0.5, ax).numpy(),
                                      ref)
    assert torch.round(torch.tensor([0.5, 1.5, 2.5])).tolist() == [0.0, 2.0, 2.0]


NNUNET_BATCH = 8


def _nnunet(spatial_dims):
    patch = [12, 14, 13] if spatial_dims == 3 else [20, 18]
    t = dict(_flagship_transformations()["ae_transformations"], aug_preset="nnunet",
             patch_size=patch, **ALL_ON)
    j = jaug.AugmentConfig.from_transformations(t, spatial_dims=spatial_dims)
    return t, j, taug.AugmentConfig.from_transformations(t, spatial_dims=spatial_dims)


def _all_coins_on(d, batch):
    coins = [d.rot_on, d.scale_on, d.noise_on, d.elastic_on, d.blur_on, d.bright_on,
             d.contrast_on, d.gamma_on, d.lowres_on & d.lowres_chan_on.any(-1)]
    return all(bool(c[:batch].any()) for c in coins)


# seeds at which, over a batch of 8, every coin (rotation, scale, noise,
# elastic, blur, low resolution with a channel on, brightness, contrast,
# gamma) is on for at least one sample
@pytest.mark.parametrize("spatial_dims,seed", [(3, 6), (2, 7)])
def test_nnunet_augment_batch_with_every_transform_matches_jax(spatial_dims, seed):
    """The whole ``augment_batch`` under the nnunet preset with noise,
    elastic, blur and low resolution on (3D: rotation about all three axes
    from the enlarged initial patch; 2D: in-plane), against the JAX
    ``augment_batch`` fed the same keys."""
    t, jcfg, tcfg = _nnunet(spatial_dims)
    assert jcfg.rot_3d == (spatial_dims == 3) and {f: getattr(tcfg, f) for f in jcfg._fields} \
        == jcfg._asdict()
    B, C = NNUNET_BATCH, 2
    initial = tpatches.compute_initial_patch_size(t)[-spatial_dims:]
    x = np.random.default_rng(seed).uniform(0, 1, (B, *initial, C)).astype(np.float32)
    rng = jax.random.PRNGKey(200 + seed)
    draws = jax_draws(rng, B, C, jcfg, spatial_dims)
    assert _all_coins_on(draws, B)
    ref = np.asarray(jaug.augment_batch(jnp.asarray(x), rng, jcfg))
    got = taug.augment_batch(torch.from_numpy(x), draws, tcfg).numpy()
    assert got.shape == ref.shape == (B, *t["patch_size"], C)
    np.testing.assert_allclose(got, ref, **AUG_TOL)
