"""PyTorch port, sampling: schedule tables and steps, DDIM / DDPM
trajectories + decode through ``LDMSampler`` against the JAX package's
``LDMTrainer.sample_images`` (fed the same x_T and noise), the CLI, import
hygiene, and the no-silent-CPU rule of the entry points."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from medical_image_generation_tpu.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from medical_image_generation_tpu.training.train_ldm import LDMTrainer
from medical_image_generation_tpu_torch import _device
from medical_image_generation_tpu_torch.diffusion.sampler import DDIMSampler
from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule
from medical_image_generation_tpu_torch.io.nifti import load_nifti
from medical_image_generation_tpu_torch.training import sample as tsample
from medical_image_generation_tpu_torch.training.sample import LDMSampler
from torch_parity import nd, tiny_unet_pair, tiny_vae_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on the CPU; a few U-Net evaluations of summation-order noise, then the
# decode and the clip to [0, 1]
TRAJ_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["scaled_linear_beta", "linear_beta", "cosine"])
def test_schedule_tables_equal_jax(kind):
    j = JNoiseSchedule.create(100, kind)
    t = NoiseSchedule.create(100, kind)
    for name in ("betas", "alphas", "alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_steps_match_jax(pred):
    j = JNoiseSchedule.create(50, prediction_type=pred)
    t = NoiseSchedule.create(50, prediction_type=pred)
    x, out, noise = nd((3, 4, 4, 2), 0), nd((3, 4, 4, 2), 1), nd((3, 4, 4, 2), 2)
    ts, tp = np.array([49, 10, 0]), np.array([39, 0, -1])
    T = [torch.from_numpy(a) for a in (out, x, noise)]
    np.testing.assert_allclose(
        t.step(T[0], torch.from_numpy(ts), T[1], T[2]).numpy(),
        np.asarray(j.step(jnp.asarray(out), jnp.asarray(ts), jnp.asarray(x),
                          jnp.asarray(noise))), rtol=1e-5, atol=1e-5)
    for eta in (0.0, 0.5):
        np.testing.assert_allclose(
            t.ddim_step(T[0], torch.from_numpy(ts), torch.from_numpy(tp), T[1], eta,
                        T[2]).numpy(),
            np.asarray(j.ddim_step(jnp.asarray(out), jnp.asarray(ts), jnp.asarray(tp),
                                   jnp.asarray(x), eta, jnp.asarray(noise))),
            rtol=1e-5, atol=1e-5)


def test_ddim_ladder_equals_jax():
    from medical_image_generation_tpu.diffusion.sampler import DDIMSampler as JDDIM

    for steps in (5, 50, 333):
        j = JDDIM(JNoiseSchedule.create(1000), lambda p, x, t: x, num_inference_steps=steps)
        t = DDIMSampler(NoiseSchedule.create(1000), num_inference_steps=steps)
        assert t.ts == np.asarray(j._ts).tolist()
        assert t.ts_prev == np.asarray(j._ts_prev).tolist()


def _jax_trainer(jm, uparams, jvae, vparams, schedule, scale, latent_shape, num_classes=None):
    """An LDMTrainer carrying just what ``sample_images`` reads (no data,
    no checkpoint on disk)."""
    tr = object.__new__(LDMTrainer)
    tr.config = {}
    tr.unet, tr.autoencoder, tr.ae_params = jm, jvae, vparams
    tr.schedule = schedule
    tr.latent_space_type = "vae"
    tr.scale_factor = scale
    tr.latent_shape = latent_shape
    tr.class_cond = {"num_classes": num_classes} if num_classes else None
    tr.num_classes = num_classes
    tr.guidance_scale = 2.0
    return tr, type("State", (), {"params": uparams})()


@pytest.mark.parametrize("sampler,T,steps,num_classes", [
    ("ddim", 1000, 5, None),      # DDIM trajectory + decode
    ("ddim", 1000, 3, 2),         # classifier-free guided DDIM
    ("ddpm", 4, None, None),      # ancestral steps with per-step noise
])
def test_ldm_sampling_matches_jax_sample_images(sampler, T, steps, num_classes):
    jm, uparams, tm, latent, ddpm_p = tiny_unet_pair(
        num_classes + 1 if num_classes else None, seed=11)
    jvae, vparams, tvae, _ = tiny_vae_pair(seed=12)
    scale = 0.8
    shape = (2, *latent, ddpm_p["in_channels"])
    jsched = JNoiseSchedule.create(T)
    tr, state = _jax_trainer(jm, uparams, jvae, vparams, jsched, scale, shape, num_classes)
    rng = jax.random.PRNGKey(4)
    label = 1 if num_classes else None
    ref = tr.sample_images(state, 2, rng, sampler=sampler, num_inference_steps=steps,
                           class_label=label)

    # the JAX samplers' draws: x_T from split(rng)[1], then one key per step
    carry, init = jax.random.split(rng)
    x_T = torch.from_numpy(np.array(jax.random.normal(init, shape)))
    noises = []
    for _ in range(T):
        carry, k = jax.random.split(carry)
        noises.append(torch.from_numpy(np.array(jax.random.normal(k, shape))))
    ts = LDMSampler(tm, tvae, NoiseSchedule.create(T), scale, shape, num_classes,
                    guidance_scale=2.0, device="cpu")
    got = ts.sample(2, sampler=sampler, num_inference_steps=steps, class_label=label,
                    x_T=x_T, noises=noises)
    assert got.shape == ref.shape == (2, 32, 32, 32, 1)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, **TRAJ_TOL)


def test_cli_writes_volumes(tmp_path):
    _, _, tm, latent, ddpm_p = tiny_unet_pair(seed=2)
    _, _, tvae, vae_p = tiny_vae_pair(seed=3)
    ckpt = tmp_path / "ldm.pt"
    torch.save({"unet": tm.state_dict(), "vae": tvae.state_dict(), "scale_factor": 1.3,
                "latent_shape": [1, *latent, ddpm_p["in_channels"]]}, ckpt)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({"vae_params": vae_p, "ddpm_params": ddpm_p,
                                   "time_scheduler_params": {"num_train_timesteps": 100}}))
    out = tmp_path / "samples"
    tsample.main_ldm([str(cfg), str(ckpt), "-n", "2", "--num_inference_steps", "2",
                      "--dtype", "fp32", "--device", "cpu", "-o", str(out)])
    vols = sorted(os.listdir(out))
    assert vols == ["ldm_sample_000.nii.gz", "ldm_sample_001.nii.gz"]
    sampler = LDMSampler.from_config(yaml.safe_load(cfg.read_text()), tm.state_dict(),
                                     tvae.state_dict(), 1.3, [1, *latent, ddpm_p["in_channels"]],
                                     dtype=torch.float32, device="cpu")
    want = sampler.sample(2, sampler="ddim", num_inference_steps=2,
                          generator=torch.Generator().manual_seed(0))
    for name, img in zip(vols, want):  # NIfTI (X, Y, Z) order of the (Z, Y, X, 1) sample
        nii = load_nifti(str(out / name))
        assert nii.data.shape == (32, 32, 32) and nii.data.dtype == np.float32
        np.testing.assert_array_equal(nii.data, np.transpose(img[..., 0], (2, 1, 0)))
        np.testing.assert_array_equal(nii.affine, np.eye(4))


def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _device.resolve_device()
    _, _, tm, latent, ddpm_p = tiny_unet_pair(seed=2)
    _, _, tvae, _ = tiny_vae_pair(seed=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LDMSampler(tm, tvae, NoiseSchedule.create(10), 1.0, (1, *latent, 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsample.main_ldm([str(tmp_path / "c.yaml"), str(tmp_path / "c.pt")])
    assert _device.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    """The port package and every module in it load without JAX, flax,
    optax, orbax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import medical_image_generation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'medical_image_generation_tpu'))\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
