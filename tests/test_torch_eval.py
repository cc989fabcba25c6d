"""PyTorch port, the generative eval: SSIM / MS-SSIM / all-pairs metrics,
FID and MMD, the ResNet50 feature extractor (random instance-norm and
frozen-BN modes, 2D and 3D with MedicalNet's dilated stages, a synthetic
``MEDIMGEN_FID_WEIGHTS_*`` file) and ``LDMTrainer.evaluate_generation``,
each against the JAX package from the same inputs and weights. fp32 on the
CPU (the JAX extractor's default is bf16 in random mode; the tests pass
fp32 to both)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.eval import features as jfeat
from medical_image_generation_tpu.eval import fid as jfid
from medical_image_generation_tpu.eval import mmd as jmmd
from medical_image_generation_tpu.training.train_ldm import LDMTrainer as JLDMTrainer
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.eval import features as tfeat
from medical_image_generation_tpu_torch.eval import fid as tfid
from medical_image_generation_tpu_torch.eval import mmd as tmmd
from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer
from torch_parity import init_shapes, rand_params

jssim = importlib.import_module("medical_image_generation_tpu.eval.ssim")
tssim = importlib.import_module("medical_image_generation_tpu_torch.eval.ssim")

FEAT_TOL = 1e-4  # features: max abs error / max |feature| (fp32 convs summed in another order)


def structured(n, shape, seed):
    """n images of ``shape`` (*spatial, C) in [0, 1] that share a smooth
    pattern to different degrees, so SSIM spreads over (0, 1) and some
    pairs' coarse scales fall to the 1e-6 clip."""
    rng = np.random.default_rng(seed)
    spatial = shape[:-1]
    grids = np.meshgrid(*[np.linspace(0, 3, s) for s in spatial], indexing="ij")
    base = np.sin(sum(g * (i + 1) for i, g in enumerate(grids)))[..., None]
    out = []
    for i in range(n):
        w = rng.uniform(0, 1)
        noise = rng.standard_normal(shape)
        out.append(0.5 + 0.25 * (w * base + (1 - w) * noise))
    return np.clip(np.stack(out), 0, 1).astype(np.float32)


@pytest.mark.parametrize("shape,chunk", [((32, 32, 1), 7), ((64, 48, 2), 0),
                                         ((16, 16, 16, 1), 5)])
def test_pairwise_metrics_match_jax(shape, chunk):
    """All C(n, 2) pairs, with a padded tail chunk where ``chunk`` does not
    divide them: each pair's SSIM and MS-SSIM (window 4) within 1e-5, the
    means and stds within 1e-6, the same pair count."""
    imgs = structured(9, shape, seed=len(shape) + chunk)
    ref = jssim.pairwise_metrics(imgs, win_size=4, pairs_per_chunk=chunk)
    got = tssim.pairwise_metrics(imgs, win_size=4, pairs_per_chunk=chunk, device="cpu")
    assert got["n_pairs"] == ref["n_pairs"] == 36 and (chunk == 0 or 36 % chunk)
    for k in ("ssim_mean", "ssim_std", "ms_ssim_mean", "ms_ssim_std"):
        assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])
    idx = tssim.pair_indices(9)
    a, b = imgs[idx[:, 0]], imgs[idx[:, 1]]
    for name in ("ssim", "ms_ssim"):
        r = np.asarray(getattr(jssim, name)(jnp.asarray(a), jnp.asarray(b), win_size=4))
        g = getattr(tssim, name)(torch.from_numpy(a), torch.from_numpy(b), win_size=4).numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("spatial,win,scales", [((128, 128), 4, 5), ((16, 16, 16), 4, 3),
                                                ((32, 40), 7, 3), ((8, 8), 7, 1)])
def test_ms_ssim_scale_count_equals_jax(spatial, win, scales):
    """The scale count follows the smallest side and the window (JAX
    ssim.py:87-91); MS-SSIM of an image with itself is 1."""
    assert tssim.num_scales(spatial, win) == scales
    x = structured(2, (*spatial, 1), seed=3)
    ref = np.asarray(jssim.ms_ssim(jnp.asarray(x), jnp.asarray(x[::-1]), win_size=win))
    got = tssim.ms_ssim(torch.from_numpy(x), torch.from_numpy(x[::-1].copy()), win_size=win)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    same = tssim.ms_ssim(torch.from_numpy(x), torch.from_numpy(x), win_size=win)
    np.testing.assert_allclose(same.numpy(), 1.0, rtol=0, atol=1e-5)


def test_pairwise_metrics_of_one_image_is_nan():
    got = tssim.pairwise_metrics(np.zeros((1, 8, 8, 1), np.float32), device="cpu")
    assert got["n_pairs"] == 0 and np.isnan(got["ssim_mean"])


@pytest.mark.parametrize("n_real,n_fake,dim", [(40, 40, 64), (30, 12, 256)])
def test_fid_and_mmd_match_jax(n_real, n_fake, dim):
    """float64 on the host in both packages: relative 1e-9."""
    rng = np.random.default_rng(dim)
    real = rng.standard_normal((n_real, dim)).astype(np.float32)
    fake = (0.8 * rng.standard_normal((n_fake, dim)) + 0.3).astype(np.float32)
    for t_fn, j_fn in ((tfid.fid_from_features, jfid.fid_from_features),
                       (tmmd.mmd_from_features, jmmd.mmd_from_features)):
        got, ref = t_fn(real, fake), j_fn(real, fake)
        assert np.isfinite(got) and got > 0
        np.testing.assert_allclose(got, ref, rtol=1e-9)


def _jax_features(sd, frozen, seed):
    """(flax module, params with positive variances) of a ResNet50Features."""
    stages = jfeat.MEDICALNET_STAGES if (frozen and sd == 3) else jfeat.RESNET50_STAGES
    jm = jfeat.ResNet50Features(spatial_dims=sd, stages=stages, frozen_bn=frozen,
                                dtype=jnp.float32)
    x0 = jnp.zeros((1,) + (16,) * sd + ((3,) if sd == 2 else (1,)))
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), x0), seed)

    def fix(path, v):
        return np.abs(v) + 0.5 if path[-1].key == "var" else v

    return jm, jax.tree_util.tree_map_with_path(fix, params), stages


@pytest.mark.parametrize("sd,frozen,size", [
    pytest.param(2, False, 128, id="2d-instance-norm"),
    pytest.param(2, True, 32, id="2d-frozen-bn"),
    pytest.param(3, False, 16, id="3d-instance-norm"),
    pytest.param(3, True, 16, id="3d-frozen-bn-medicalnet")])
def test_resnet50_features_match_jax(sd, frozen, size):
    """Global-pooled 2048-d features through ``convert.features_from_flax``
    within 1e-4 of the largest feature. The 2D instance-norm case runs at
    128^2: at 32^2 its last stages normalise 1 and 4 pixels a channel, which
    amplify the fp32 convs' rounding by 1 / std (1.3e-4 to 2.6e-4 there)."""
    jm, params, stages = _jax_features(sd, frozen, seed=sd * 10 + frozen)
    x = np.random.default_rng(5).uniform(0, 1, (2,) + (size,) * sd
                                         + ((3,) if sd == 2 else (1,))).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = tfeat.ResNet50Features(sd, stages, frozen, dtype=torch.float32, device="cpu")
    sd_ = convert.features_from_flax({"params": params})
    assert set(sd_) == set(tm.state_dict())
    tm.load_state_dict(sd_)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 2048) and got.dtype == np.float32
    assert float(np.abs(got - ref).max()) <= FEAT_TOL * float(np.abs(ref).max())
    if frozen and sd == 3:  # MedicalNet's layer3 / layer4 are dilated, stride 1
        c = tm._Bottleneck_7.ConvND_1.Conv_0
        assert c.dilation == (2, 2, 2) and c.padding == (2, 2, 2) and c.stride == (1, 1, 1)


def test_feature_extractor_reads_the_jax_npz(tmp_path, monkeypatch):
    """``MEDIMGEN_FID_WEIGHTS_2D``: an .npz of flax paths written from a
    JAX-initialised pretrained tree, read by both packages' extractors
    (frozen BN, fp32): the same weights and the same preprocessed features;
    a file that lacks an array is refused. (The 3D pretrained network,
    MedicalNet's dilated stages, is held by
    ``test_resnet50_features_match_jax``; the file reading is the same.)"""
    from flax import traverse_util

    sd = 2
    jm, params, _ = _jax_features(sd, True, seed=40 + sd)
    path = tmp_path / f"fid{sd}d.npz"
    flat = traverse_util.flatten_dict({"params": jax.device_get(params)}, sep="/")
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    monkeypatch.setenv(f"MEDIMGEN_FID_WEIGHTS_{sd}D", str(path))
    jfe = jfeat.FeatureExtractor(spatial_dims=sd)
    tfe = tfeat.FeatureExtractor(spatial_dims=sd, device="cpu")
    assert jfe.pretrained and tfe.pretrained and tfe.dtype == torch.float32
    want = convert.features_from_flax(jfe.params)
    assert all(torch.equal(v, want[k]) for k, v in tfe.module.state_dict().items())
    imgs = structured(3, (32, 32, 1), seed=sd)
    ref, got = np.asarray(jfe(imgs)), tfe(imgs)
    assert got.shape == (3, 2048)
    assert float(np.abs(got - ref).max()) <= FEAT_TOL * float(np.abs(ref).max())
    partial = {k: np.asarray(v) for k, v in list(flat.items())[1:]}
    np.savez(path, **partial)
    with pytest.raises(ValueError, match="missing"):
        tfe.load_flax(tfeat.load_npz(str(path)), str(path))


@pytest.mark.parametrize("sd,channels", [(2, 1), (2, 2), (2, 3), (3, 1), (3, 2)])
def test_feature_extractor_preprocessing_equals_jax(sd, channels):
    """Gray -> 3 channels, BGR and the mean in 2D; the per-volume z-score in
    3D (C > 1 collapses to one channel), as the JAX extractor's
    preprocessing."""
    imgs = structured(2, (8,) * sd + (channels,), seed=channels)
    jfe, tfe = object.__new__(jfeat.FeatureExtractor), object.__new__(tfeat.FeatureExtractor)
    pre_j = (jfe.preprocess_2d if sd == 2 else jfe.preprocess_3d)(jnp.asarray(imgs))
    pre_t = (tfe.preprocess_2d if sd == 2 else tfe.preprocess_3d)(torch.from_numpy(imgs))
    np.testing.assert_allclose(pre_t.numpy(), np.asarray(pre_j), rtol=1e-6, atol=1e-6)


def test_feature_extractor_random_mode_is_bf16_and_seeded(monkeypatch):
    """Without a weights file: random features in bf16 whose first conv is
    the first draw of ``torch.Generator(0)`` from flax's ``lecun_normal``
    (a normal of std sqrt(1 / fan_in) truncated at two), and 2048 finite
    fp32 features an image."""
    monkeypatch.delenv("MEDIMGEN_FID_WEIGHTS_2D", raising=False)
    tfe = tfeat.FeatureExtractor(spatial_dims=2, device="cpu")
    assert not tfe.pretrained and tfe.dtype == torch.bfloat16
    w = tfe.module.ConvND_0.Conv_0.weight
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    want = torch.empty(w.shape)
    torch.nn.init.trunc_normal_(want, 0.0, std, -2 * std, 2 * std,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, want.to(w.dtype))
    out = tfe(structured(1, (32, 32, 1), seed=9))
    assert out.shape == (1, 2048) and out.dtype == np.float32 and np.isfinite(out).all()


# ---------------------------------------------------------- evaluate_generation


def _trainers(sd, seed, config):
    """A JAX and a port LDMTrainer carrying what ``evaluate_generation``
    reads, each with an fp32 extractor holding the same JAX-initialised
    random-feature weights."""
    jtr = object.__new__(JLDMTrainer)
    ttr = object.__new__(LDMTrainer)
    for tr in (jtr, ttr):
        tr.spatial_dims, tr.seed, tr.config = sd, seed, config
    ttr.device = torch.device("cpu")
    jtr._extractor = jfeat.FeatureExtractor(spatial_dims=sd, dtype=jnp.float32)
    ttr._extractor = tfeat.FeatureExtractor(spatial_dims=sd, dtype=torch.float32, device="cpu")
    ttr._extractor.load_flax(jax.device_get(jtr._extractor.params))
    return jtr, ttr


@pytest.mark.parametrize("sd,size,n", [(2, 128, 6)])
def test_evaluate_generation_matches_jax(sd, size, n, monkeypatch):
    """``sample_images`` stubbed to the same fixed arrays in both packages,
    the same val batches, the converted extractor: FID within 1e-4
    relative, SSIM and MS-SSIM means and stds within 1e-5, MMD within 1e-5."""
    monkeypatch.delenv(f"MEDIMGEN_FID_WEIGHTS_{sd}D", raising=False)
    shape = (size,) * sd + (1,)
    fake = structured(n, shape, seed=21)
    val = [structured(4, shape, seed=30 + i) for i in range(n // 4 + 2)]
    jtr, ttr = _trainers(sd, 5, {"eval_mmd": True})
    calls = {"j": [], "t": []}

    def j_sample(state, take, rng, sampler="ddpm", num_inference_steps=None):
        k = sum(calls["j"])
        calls["j"].append(take)
        return fake[k:k + take]

    def t_sample(take, sampler="ddim", num_inference_steps=None, generator=None):
        k = sum(calls["t"])
        calls["t"].append(take)
        return fake[k:k + take]

    jtr.sample_images, ttr.sample_images = j_sample, t_sample
    ref = jtr.evaluate_generation(None, val, n_samples=n)
    got = ttr.evaluate_generation(val, n_samples=n)
    cap = 16 if sd == 2 else 2
    assert calls["j"] == calls["t"] and max(calls["t"]) <= cap and sum(calls["t"]) == n
    assert got["n_pairs"] == ref["n_pairs"] == n * (n - 1) // 2
    np.testing.assert_allclose(got["fid"], ref["fid"], rtol=1e-4)
    # MMD^2 is a difference of kernel means, each in [0, 1]: absolute 1e-5
    assert abs(got["mmd"] - ref["mmd"]) <= 1e-5, (got["mmd"], ref["mmd"])
    for k in ("ssim", "ms_ssim", "ssim_std", "ms_ssim_std"):
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])
    assert set(got["seconds"]) == {"sampling", "features", "fid", "pairwise", "mmd"}


@pytest.mark.parametrize("sd,n,cap", [(2, 100, 16), (3, 40, 2)])
def test_evaluate_generation_protocol_defaults(sd, n, cap, monkeypatch):
    """The default protocol: n = 100 (2D) / 40 (3D) samples, at most 16 / 2
    a ``sample_images`` call, the ``ddpm`` sampler with the full trajectory
    (no step count) from one generator seeded ``seed + 777`` that carries
    on across the calls, ``eval_sampler`` / ``eval_num_inference_steps``
    passed through, real images taken from the val loader until n are
    there, the extractor built once, and no MMD unless ``eval_mmd``."""
    monkeypatch.delenv(f"MEDIMGEN_FID_WEIGHTS_{sd}D", raising=False)
    shape = (8,) * sd + (1,)
    seen = {"calls": [], "gens": set(), "extractors": 0, "feats": []}

    class Extractor:
        def __init__(self, spatial_dims, device):
            seen["extractors"] += 1

        def __call__(self, images):
            seen["feats"].append(len(images))
            return np.random.default_rng(len(seen["feats"])).standard_normal((len(images), 6))

    monkeypatch.setattr("medical_image_generation_tpu_torch.training.train_ldm."
                        "FeatureExtractor", Extractor)
    for config, sampler, steps in (({}, "ddpm", None),
                                   ({"eval_sampler": "ddim", "eval_num_inference_steps": 7},
                                    "ddim", 7)):
        tr = object.__new__(LDMTrainer)
        tr.spatial_dims, tr.seed, tr.config, tr.device = sd, 3, config, torch.device("cpu")
        seen["calls"].clear()
        seen["gens"].clear()

        def sample(take, sampler=None, num_inference_steps=None, generator=None):
            seen["calls"].append((take, sampler, num_inference_steps))
            seen["gens"].add(id(generator))
            seen["first"] = seen.get("first") or generator.initial_seed()
            return np.full((take, *shape), 0.5, np.float32) + 0.01 * np.random.default_rng(
                len(seen["calls"])).standard_normal((take, *shape)).astype(np.float32)

        tr.sample_images = sample
        val = (np.full((7, *shape), 0.3, np.float32) for _ in range(100))
        out = tr.evaluate_generation(val)
        takes = [c[0] for c in seen["calls"]]
        assert sum(takes) == n and max(takes) == cap and takes[-1] == n - cap * (len(takes) - 1)
        assert {c[1:] for c in seen["calls"]} == {(sampler, steps)}
        assert len(seen["gens"]) == 1 and seen["first"] == 3 + 777
        assert seen["feats"][-2:] == [n, n] and out["n_pairs"] == n * (n - 1) // 2
        assert "mmd" not in out
        tr.evaluate_generation((np.zeros((n, *shape), np.float32) for _ in range(1)))
        assert seen["extractors"] == (1 if not config else 2)
