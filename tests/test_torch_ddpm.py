"""PyTorch port, the pixel-space DDPM: one port ``DDPMTrainer.train_step``
against the shipped JAX ``DDPMTrainer._make_train_step`` fed the same random
numbers (without labels and with CFG labels), ``val_step`` against
``_make_val_step``, ``sample_images`` (DDIM, guided DDIM, ancestral DDPM)
against the JAX ``sample_images`` fed the same x_T and per-step noise, the
mode filter before ``--set``, and the CLI pair
``medimgen_torch_train_ddpm`` -> ``-c`` -> ``medimgen_torch_sample_ddpm`` in
2D (PNGs) and 3D (``.nii.gz``). fp32 on the CPU, the tiny config with in and
out channels 1."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from medical_image_generation_tpu.config.run import filter_config_by_mode as jfilter
from medical_image_generation_tpu.parallel.mesh import get_mesh
from medical_image_generation_tpu.training import common as jcommon
from medical_image_generation_tpu.training.train_ddpm import DDPMTrainer as JDDPMTrainer
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.config.run import filter_config_by_mode
from medical_image_generation_tpu_torch.data import loader as tloader
from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
from medical_image_generation_tpu_torch.io import png as tpng
from medical_image_generation_tpu_torch.io.nifti import load_nifti
from medical_image_generation_tpu_torch.io.volstore import write_volume
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.planning import planner as tplanner
from medical_image_generation_tpu_torch.planning.preprocess import save_properties
from medical_image_generation_tpu_torch.training import checkpoints as tckpt
from medical_image_generation_tpu_torch.training import sample as tsample
from medical_image_generation_tpu_torch.training import train_ddpm
from medical_image_generation_tpu_torch.training.common import TrainDraws
from medical_image_generation_tpu_torch.training.train_ddpm import DDPMTrainer
from test_torch_augment import jax_draws
from torch_parity import init_shapes, rand_params

LR = 2e-5
# fp32 on the CPU, as tests/test_torch_sampling.py holds the LDM sampler: a
# few U-Net evaluations of summation-order noise (their outputs agree to
# ~1e-6 relative), which the first DDIM step divides by sqrt(alpha_bar) of
# t = 999 (~0.006 on the DDPM's linear_beta schedule), then the clip
TRAJ_TOL = dict(rtol=2e-4, atol=2e-4)


def _config(spatial_dims=3, T=50, **over):
    vae, ddpm, _ = tplanner.flagship_configs(tiny=True, spatial_dims=spatial_dims)
    cfg = tplanner.create_config_dict(tplanner.flagship_dataset(True, spatial_dims), [0], 1,
                                      vae, ddpm)
    cfg = filter_config_by_mode(cfg, "train_ddpm")
    cfg["time_scheduler_params"] = dict(cfg["time_scheduler_params"], num_train_timesteps=T)
    cfg.update(over)
    return cfg


def _pair(cfg, tmp_path, seed):
    """(JAX DDPMTrainer, its flax params, port DDPMTrainer) with the same
    seeded U-Net weights (in and out channels 1)."""
    jcfg = dict(cfg, results_path=str(tmp_path / "jax_run"))
    jt = JDDPMTrainer(jcfg, dtype=jnp.float32, mesh=get_mesh(n_devices=1))
    kw = {"class_labels": jnp.zeros((1,), jnp.int32)} if jt.class_cond else {}
    params = rand_params(init_shapes(jt.unet, jax.random.PRNGKey(0),
                                     jnp.zeros((1,) + jt.image_shape),
                                     jnp.zeros((1,), jnp.int32), **kw), seed)
    unet_params, _ = tsample.ddpm_unet_params(cfg)
    unet = DiffusionUNet.from_config(unet_params, dtype=torch.float32, device="cpu")
    unet.load_state_dict(convert.unet_from_flax(params))
    return jt, params, DDPMTrainer(cfg, unet, device="cpu")


def _state(jt, params):
    tx = jcommon.make_optimizer(jcommon.make_lr_schedule(LR, None, None, 250), 1.0, 1,
                                weight_decay=1e-2, mu_dtype=jcommon.mu_dtype_from_config({}))
    return jcommon.TrainState.create(apply_fn=jt.unet.apply, params=params, tx=tx)


@pytest.mark.parametrize("spatial_dims,labeled", [(3, False), (2, True)],
                         ids=["3d-unlabeled", "2d-cfg-labels"])
def test_train_step_matches_jax_make_train_step(tmp_path, spatial_dims, labeled):
    """One port train_step against the shipped JAX step from the same weights
    and the same draws (``split(rng, 4)``: augment, t, noise, dropout;
    train_ddpm.py:138-170). Loss to rtol 1e-4; the params after the update
    as ``test_torch_training.py::test_train_step_matches_jax_make_train_step``
    holds them: Adam's first update is -lr (g / (|g| + eps) + wd p), so u =
    (p_old - p_new) / lr - wd p_old is about sign(g); where the JAX |u| >
    0.99 the port's u agrees to 1e-3, elsewhere |u| <= 1 for at most 1% of
    the elements; both beside the rounding of p_new to fp32 in each
    package, 2^-22 |p| / lr in u (1.5e-3 at |p| = 0.25: the pixel-space
    U-Net's 16-wide attention projections hold such weights)."""
    cc = {"num_classes": 3, "dropout_prob": 0.5} if labeled else None
    cfg = _config(spatial_dims, class_conditioning=cc)
    jt, params, tr = _pair(cfg, tmp_path, seed=51)
    state = _state(jt, params)
    initial = compute_initial_patch_size(cfg["ddpm_transformations"])
    x = np.random.default_rng(52).uniform(0, 1, (2, *initial, 1)).astype(np.float32)
    labels = np.array([2, 0], np.int32) if labeled else None
    rng = jax.random.PRNGKey(53)
    p_old = {n: p.detach().clone() for n, p in tr.unet.named_parameters()}

    aug_rng, t_rng, n_rng, d_rng = jax.random.split(rng, 4)
    shape = (2, *cfg["ddpm_transformations"]["patch_size"], 1)
    draws = TrainDraws(
        augment=jax_draws(aug_rng, 2, 1, jt.aug_cfg), eps=None,
        t=torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 50))).long(),
        noise=torch.from_numpy(np.array(jax.random.normal(n_rng, shape, jnp.float32))),
        drop=(torch.from_numpy(np.array(jax.random.uniform(d_rng, (2,)) < 0.5))
              if labeled else None))
    assert tr.make_draws(torch.from_numpy(x), labels).eps is None
    batch = ({"image": jnp.asarray(x), "class": jnp.asarray(labels)} if labeled
             else jnp.asarray(x))
    state, jloss = jt._make_train_step()(state, batch, rng)
    loss = tr.train_step(torch.from_numpy(x), torch.from_numpy(labels).long() if labeled
                         else None, draws=draws)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)

    new_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    n_off, n_all = 0, 0
    for name, p in tr.unet.named_parameters():
        old = p_old[name]
        u_j = (old - new_ref[name]) / LR - 1e-2 * old
        u_t = (old - p.detach()) / LR - 1e-2 * old
        firm = u_j.abs() > 0.99
        ulp = 2.0 ** -22 * old.abs() / LR  # p_new's fp32 rounding in each package, in u
        assert bool(((u_t - u_j).abs() <= 1e-3 + ulp)[firm].all()), name
        assert bool((u_t.abs() <= 1.0 + ulp + 1e-6).all()), name
        n_off += int((~firm).sum())
        n_all += firm.numel()
    assert n_off <= 0.01 * n_all, (n_off, n_all)
    assert tr.step == 1 and tr.opt.mu[0].dtype == torch.bfloat16


def test_val_step_matches_jax_make_val_step(tmp_path):
    """``val_step`` against ``_make_val_step`` (train_ddpm.py:172-191) on a
    final-size batch with labels passed through (no dropout), rtol 1e-4."""
    cfg = _config(class_conditioning={"num_classes": 3, "dropout_prob": 0.5})
    jt, params, tr = _pair(cfg, tmp_path, seed=54)
    x = np.random.default_rng(55).uniform(0, 1, (2, 32, 32, 32, 1)).astype(np.float32)
    labels = np.array([1, 2], np.int32)
    rng = jax.random.PRNGKey(56)
    t_rng, n_rng = jax.random.split(rng)
    draws = TrainDraws(
        augment=None, eps=None,
        t=torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 50))).long(),
        noise=torch.from_numpy(np.array(jax.random.normal(n_rng, x.shape, jnp.float32))))
    ref = jt._make_val_step()(_state(jt, params),
                              {"image": jnp.asarray(x), "class": jnp.asarray(labels)}, rng)
    got = tr.val_step(torch.from_numpy(x), torch.from_numpy(labels).long(), draws=draws)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-4)


@pytest.mark.parametrize("sampler,T,steps,num_classes", [
    ("ddim", 1000, 5, None),      # DDIM trajectory, clipped
    ("ddim", 1000, 3, 2),         # classifier-free guided DDIM
    ("ddpm", 4, None, None),      # ancestral steps with per-step noise
])
def test_sample_images_matches_jax(tmp_path, sampler, T, steps, num_classes):
    """``sample_images`` against the JAX ``sample_images``
    (train_ddpm.py:193-250) in 2D, fed the JAX samplers' own draws: x_T
    from ``split(rng)[1]``, then one key a step. Clipped to [0, 1];
    tolerance ``TRAJ_TOL``."""
    cc = {"num_classes": num_classes, "dropout_prob": 0.1} if num_classes else None
    cfg = _config(spatial_dims=2, T=T, class_conditioning=cc)
    jt, params, tr = _pair(cfg, tmp_path, seed=57)
    rng = jax.random.PRNGKey(58)
    label = 1 if num_classes else None
    state = type("State", (), {"params": params})()
    ref = jt.sample_images(state, 2, rng, sampler=sampler, num_inference_steps=steps,
                           class_label=label)
    shape = (2, 32, 32, 1)
    carry, init = jax.random.split(rng)
    x_T = torch.from_numpy(np.array(jax.random.normal(init, shape)))
    noises = []
    for _ in range(T if sampler == "ddpm" else 0):
        carry, k = jax.random.split(carry)
        noises.append(torch.from_numpy(np.array(jax.random.normal(k, shape))))
    got = tr.sample_images(2, sampler=sampler, num_inference_steps=steps, class_label=label,
                           x_T=x_T, noises=noises or None)
    assert got.shape == ref.shape == shape
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, **TRAJ_TOL)


def test_filter_by_mode_before_overrides_keeps_the_users_schedule(tmp_path, monkeypatch):
    """The CLI filters the config by mode before ``--set``: the planner's
    DDPM schedule replaces the LDM's, and a user's ``--set
    time_scheduler_params.*`` wins over that swap (JAX train_ddpm.py:
    393-397). The port's filter equals the JAX one."""
    vae, ddpm, _ = tplanner.flagship_configs(tiny=True)
    cfg = tplanner.create_config_dict(tplanner.flagship_dataset(True, 3), [0], 1, vae, ddpm)
    assert filter_config_by_mode(cfg, "train_ddpm") == jfilter(cfg, "train_ddpm")
    seen = []
    monkeypatch.setattr(train_ddpm.DDPMTrainer, "train", lambda self, a, b: seen.append(self))
    argv = _cli_dataset(tmp_path, monkeypatch, 3, cfg)
    train_ddpm.run_cli(argv)
    sched = seen[0].config["time_scheduler_params"]
    assert sched == cfg["ddpm_time_scheduler_params"] and "vae_params" not in seen[0].config
    train_ddpm.run_cli(argv + ["-c", "--set", "time_scheduler_params.beta_end=0.03"])
    assert seen[1].config["time_scheduler_params"]["beta_end"] == 0.03
    assert seen[1].config["time_scheduler_params"]["beta_start"] == sched["beta_start"]
    assert seen[1].schedule.num_train_timesteps == 1000


def _cli_dataset(tmp_path, monkeypatch, spatial_dims, cfg):
    """A preprocessed dataset of 6 patients of (1, 36, 40, 40) (the 2D
    loaders cut 32^2 slices), ``cfg`` as the planner's
    medimgen_config.yaml, the env vars, loaders of 2 train / 1 val steps.
    Returns the CLI's leading arguments."""
    pre, res = tmp_path / "pre", tmp_path / "res"
    images = pre / "Task099_Synth" / "imagesTr"
    images.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i in range(6):
        write_volume(str(images / f"p{i:03d}.vs"),
                     rng.uniform(0, 1, (1, 36, 40, 40)).astype(np.float32))
        save_properties(str(images), f"p{i:03d}",
                        {"class_locations": {1: [(z, 20, 20) for z in range(10, 26)]}})
    with open(pre / "Task099_Synth" / "medimgen_config.yaml", "w") as f:
        yaml.safe_dump({f"{spatial_dims}D": cfg}, f)
    monkeypatch.setenv("medimgen_preprocessed", str(pre))
    monkeypatch.setenv("medimgen_results", str(res))
    monkeypatch.setattr(train_ddpm, "get_data_loaders",
                        functools.partial(tloader.get_data_loaders, train_steps=2, val_steps=1,
                                          num_threads=2))
    return ["099", "train-val-test", f"{spatial_dims}d", "--device", "cpu", "--dtype", "fp32"]


def _trainer_state(tr):
    return {"params": [p.detach().clone() for p in tr.params],
            "ema": [e.clone() for e in tr.ema], "mu": [m.clone() for m in tr.opt.mu],
            "nu": [v.clone() for v in tr.opt.nu], "count": tr.opt.count, "step": tr.step,
            "host": tr.host_generator.get_state(), "device": tr.generator.get_state()}


@pytest.mark.parametrize("spatial_dims", [2, 3])
def test_ddpm_cli_trains_resumes_bit_for_bit_and_samples(tmp_path, monkeypatch, spatial_dims):
    """``medimgen_torch_train_ddpm`` for 2 epochs (EMA on, the interval
    samples at epoch 2, cut to 2 DDIM steps: 16 images as a PNG grid in 2D,
    one volume in 3D),
    last / best written with the DDPM payload; ``-c`` restores the state bit
    for bit (params, EMA, mu, nu, count, step, both generators, the train
    loader) and the next step equals the uninterrupted trainer's; then
    ``medimgen_torch_sample_ddpm`` writes PNGs and the grid (2D) or
    ``.nii.gz`` volumes (3D) of the patch size."""
    vae, ddpm, _ = tplanner.flagship_configs(tiny=True, spatial_dims=spatial_dims)
    cfg = tplanner.create_config_dict(tplanner.flagship_dataset(True, spatial_dims), [0], 1,
                                      vae, ddpm)
    cfg.update(ddpm_batch_size=2, num_workers=2)
    cfg["ddpm_time_scheduler_params"]["num_train_timesteps"] = 20
    argv = _cli_dataset(tmp_path, monkeypatch, spatial_dims, cfg)
    monkeypatch.setattr(train_ddpm.DDPMTrainer, "sample_images", functools.partialmethod(
        train_ddpm.DDPMTrainer.sample_images, num_inference_steps=2))
    sets = ["--set", "ema_decay=0.9", "--set", "val_plot_interval=2", "--set", "n_epochs=2"]
    a = train_ddpm.run_cli(argv + sets)
    ck = a.save_dict["checkpoints"]
    assert sorted(os.listdir(ck)) == ["best_model.pt", "last_model.pt"]
    assert len(a.loss_dict["rec_loss"]) == 2 and a.step == 4 and a.opt.count == 4
    saved = tckpt.load_checkpoint(os.path.join(ck, "last_model.pt"))
    assert set(saved) == {"epoch", "unet", "ema_unet", "opt_state", "step", "validation_loss",
                          "generators", "train_loader"}
    sample_file = a.epoch_stats[1]["samples"]
    if spatial_dims == 2:
        assert tpng.read_png(sample_file).shape == (4 * 32 + 6,) * 2
    else:
        assert os.path.basename(sample_file) in ("epoch_2.gif", "epoch_2.npy")

    b = train_ddpm.run_cli(argv + sets + ["-c"])
    assert b.start_epoch == 2 and b.epoch_stats == [] and b.best_val == saved["validation_loss"]
    sa, sb = _trainer_state(a), _trainer_state(b)
    for k in sa:
        if isinstance(sa[k], list):
            assert all(torch.equal(x, y) for x, y in zip(sa[k], sb[k])), k
        else:
            assert (torch.equal(sa[k], sb[k]) if isinstance(sa[k], torch.Tensor)
                    else sa[k] == sb[k]), k
    assert b.train_loader.state() == saved["train_loader"] == a.train_loader.state()
    x = torch.from_numpy(np.random.default_rng(8).uniform(
        0, 1, (2, *compute_initial_patch_size(a.config["ddpm_transformations"]), 1))
        .astype(np.float32))
    assert torch.equal(a.train_step(x), b.train_step(x))

    out = tmp_path / "samples"
    run_cfg = os.path.join(a.save_path, "config.yaml")
    tsample.main_ddpm([run_cfg, os.path.join(ck, "best_model.pt"), "-n", str(4 - spatial_dims),
                       "--num_inference_steps", "2", "--dtype", "fp32", "--device", "cpu",
                       "-o", str(out)])
    names = sorted(os.listdir(out))
    if spatial_dims == 2:
        assert names == ["ddpm_sample_000.png", "ddpm_sample_001.png", "ddpm_sample_grid.png"]
        assert tpng.read_png(str(out / names[0])).shape == (32, 32)
    else:
        assert names == ["ddpm_sample_000.nii.gz"]
        v = load_nifti(str(out / names[0])).data
        assert v.shape == (32, 32, 32) and np.isfinite(v).all()
        assert v.min() >= 0.0 and v.max() <= 1.0
    with pytest.raises(KeyError, match="unet"):
        torch.save({"epoch": 0}, tmp_path / "empty.pt")
        tsample.load_ddpm_checkpoint(str(tmp_path / "empty.pt"))
