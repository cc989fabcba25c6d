"""PyTorch port, the training CLI: config plumbing, the last/best cadence,
gradient accumulation (``optax.MultiSteps``) and the synced EMA against the
JAX package; one accumulated train step against ``_make_train_step``;
``medimgen_torch_train_ldm`` on the CPU (two epochs, ``-c`` resume bit for
bit, a third epoch), what it refuses before the first step, the sampling
weights of its checkpoints, and the orbax -> ``.pt`` bridge. fp32, tiny 3D
config (the 2D CLIs: ``tests/test_torch_cli_2d.py``)."""

import copy
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from medical_image_generation_tpu.config import run as jrun
from medical_image_generation_tpu.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from medical_image_generation_tpu.training import checkpoints as jckpt
from medical_image_generation_tpu.training import common as jcommon
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.config import run as trun
from medical_image_generation_tpu_torch.data import loader as tloader
from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule
from medical_image_generation_tpu_torch.io.nifti import load_nifti
from medical_image_generation_tpu_torch.io.volstore import write_volume
from medical_image_generation_tpu_torch.models.autoencoder_kl import AutoencoderKL
from medical_image_generation_tpu_torch.planning.preprocess import save_properties
from medical_image_generation_tpu_torch.training import checkpoints as tckpt
from medical_image_generation_tpu_torch.training import common as tcommon
from medical_image_generation_tpu_torch.training import plots as tplots
from medical_image_generation_tpu_torch.training import sample as tsample
from medical_image_generation_tpu_torch.training import train_ldm
from medical_image_generation_tpu_torch.training.sample import LDMSampler
from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer, TrainDraws
from test_torch_augment import jax_draws
from test_torch_sampling import TRAJ_TOL
from test_torch_sampling import _jax_trainer as _jax_sampling_trainer
from test_torch_training import _config, _jax_aug_cfg
from torch_parity import nd, tiny_unet_pair, tiny_vae_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 2e-5
MODES = ["train_autoencoder", "train_ldm", "train_ddpm", "sample"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --------------------------------------------------------------------- config


def _planner_file(tmp_path):
    """A medimgen_config.yaml with both dims, as the planner writes it."""
    root = tmp_path / "pre"
    (root / "Task077_Cfg").mkdir(parents=True)
    cfg3, cfg2 = _config(), _config()
    cfg2["vae_params"] = dict(cfg2["vae_params"], spatial_dims=2)
    with open(root / "Task077_Cfg" / "medimgen_config.yaml", "w") as f:
        yaml.safe_dump({"2D": cfg2, "3D": cfg3}, f)
    return str(root)


@pytest.mark.parametrize("model_type", ["2d", "3d"])
@pytest.mark.parametrize("latent", ["vae", "vq"])
def test_config_plumbing_equals_jax(tmp_path, model_type, latent):
    """get_config_for_current_task, filter_config_by_mode for every mode
    and apply_overrides give the JAX package's dicts (the port resumes from
    last_model.pt where JAX reads the orbax directory last_model)."""
    pre = _planner_file(tmp_path)
    res = str(tmp_path / "res")
    kw = dict(progress_bar=True, continue_training=True, preprocessed_root=pre,
              results_root=res)
    j = jrun.get_config_for_current_task("077", model_type, "ldm", **kw)
    t = trun.get_config_for_current_task("077", model_type, "ldm", **kw)
    assert t.pop("load_model_path") == j.pop("load_model_path") + ".pt"
    assert t == j
    j["latent_space_type"] = t["latent_space_type"] = latent
    for mode in MODES:
        assert trun.filter_config_by_mode(t, mode) == jrun.filter_config_by_mode(j, mode), mode
    sets = ["n_epochs=3", "vae_params.num_res_blocks=4", "lr_scheduler_params.power=2.0",
            "class_conditioning={num_classes: 2}", "ddpm_transformations.patch_size=[8, 8, 8]",
            "new_key.leaf=1"]
    jo = jrun.apply_overrides(copy.deepcopy(j), sets)
    to = trun.apply_overrides(copy.deepcopy(t), sets)
    assert to == jo and to["class_conditioning"] == {"num_classes": 2}
    assert to["new_key"] == {"leaf": 1}


def test_apply_overrides_raises_on_a_typo_in_an_existing_dict(capsys):
    """JAX creates the misspelt leaf silently (config/run.py:171-182); the
    port raises. An absent top-level key still only warns, as in JAX."""
    cfg = _config()
    bad = ["vae_params.num_res_blockz=3"]
    assert jrun.apply_overrides(copy.deepcopy(cfg), bad)["vae_params"]["num_res_blockz"] == 3
    with pytest.raises(KeyError, match="num_res_blockz"):
        trun.apply_overrides(copy.deepcopy(cfg), bad)
    with pytest.raises(KeyError, match="powr"):
        trun.apply_overrides(copy.deepcopy(cfg), ["lr_scheduler_params.powr=2"])
    out = trun.apply_overrides(copy.deepcopy(cfg), ["ema_decay=0.99"])
    assert out["ema_decay"] == 0.99 and "WARNING" in capsys.readouterr().out


class _Cadence:
    """What save_last_best reads of a trainer."""

    def __init__(self, cfg, n_epochs):
        self.config, self.n_epochs, self.best_val = cfg, n_epochs, float("inf")
        self.save_dict = {"checkpoints": "ck"}


@pytest.mark.parametrize("interval", [1, 2, 3])
@pytest.mark.parametrize("best_interval", [1, 2, 3])
def test_save_last_best_cadence_equals_jax(monkeypatch, interval, best_interval):
    """Over checkpoint_interval x best_checkpoint_interval x epoch, with a
    validation loss that rises and falls: the same saves in the same order,
    the same best_val, and the payload built only when something is saved."""
    losses = [5.0, 4.0, 4.5, 3.0, 3.5, 2.0, 2.5, 2.4, 1.0, 1.5, 1.2]
    cfg = {"checkpoint_interval": interval, "best_checkpoint_interval": best_interval}
    logs = []
    for pkg, name in ((jckpt, "jax"), (tckpt, "port")):
        calls = []
        monkeypatch.setattr(pkg, "save_checkpoint",
                            lambda d, n, p, calls=calls: calls.append((n, p["epoch"])))
        tr = _Cadence(cfg, len(losses))
        built, bests = [], []
        fn = jcommon.save_last_best if name == "jax" else tcommon.save_last_best
        for epoch, v in enumerate(losses):
            fn(tr, epoch, v, lambda epoch=epoch: built.append(epoch) or {"epoch": epoch})
            bests.append(tr.best_val)
        logs.append((calls, built, bests))
    assert logs[1] == logs[0]
    assert logs[1][0][-1][0] in ("last_model", "best_model")


# ----------------------------------------------------------- gradient accumulation


def test_multisteps_matches_optax_multisteps():
    """k = 3 over 9 microsteps: MultiSteps(AdamW(bf16 mu)) against
    optax.MultiSteps(chain(clip_by_global_norm, adamw(mu_dtype=bf16))):
    params, mu, nu, count, the accumulator and mini_step after every
    microstep. optax runs MultiSteps' update under lax.cond, which XLA
    compiles: fused, the CPU code skips the bf16 rounding of b1 * mu that
    op-by-op optax makes (and the port's AdamW copies, see
    test_clip_adamw_matches_optax_over_five_steps), one bf16 ulp of mu. So
    optax runs op by op here too (jax.disable_jit). The accumulator, mu and
    mini_step agree exactly; nu to 1e-6; the params to 1e-6 of their size
    plus 1e-4 of the learning rate: the clip's global norm is summed in
    another order than optax's (one fp32 ulp of the norm, which clipped
    windows pass on to every gradient element)."""
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (11,), (3, 3, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jcommon.make_optimizer(jcommon.make_lr_schedule(2e-3, None, None, 10), 1.0, 3,
                                weight_decay=1e-2, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [_t(p) for p in params]
    opt = tcommon.MultiSteps(tcommon.AdamW(tp, tcommon.make_lr_schedule(2e-3, None, None, 10),
                                           1.0, 1e-2, mu_dtype=torch.bfloat16), 3)
    for i in range(9):
        gs = [rng.standard_normal(s).astype(np.float32) * (0.05 if i % 4 else 3.0)
              for s in shapes]
        with jax.disable_jit():
            upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        synced = opt.step([_t(g) for g in gs])
        assert synced == (i % 3 == 2) and opt.mini_step == int(state.mini_step)
        adam = state.inner_opt_state[1][0]
        assert opt.count == int(adam.count) == (i + 1) // 3
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-4 * 2e-3)
        for name, ours, ref in (("mu", opt.mu, adam.mu), ("nu", opt.nu, adam.nu),
                                ("acc", opt.acc, state.acc_grads)):
            for a, b in zip(ref, ours):
                assert b.dtype == (torch.bfloat16 if name == "mu" else torch.float32)
                np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                           rtol=1e-6 if name == "nu" else 0, atol=0,
                                           err_msg=name)


def test_ema_updates_only_on_synced_steps():
    """The trainer's EMA step (ema_update when MultiSteps syncs) against
    EMATrainState.update_ema(synced=multisteps_synced(opt_state)), optax
    op by op as in the test above."""
    rng = np.random.default_rng(1)
    shapes = [(4, 3), (6,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jcommon.make_optimizer(jcommon.make_lr_schedule(1e-2, None, None, 10), 1.0, 2,
                                weight_decay=1e-2, mu_dtype=jnp.bfloat16)
    state = jcommon.EMATrainState.create(
        apply_fn=None, params=[jnp.asarray(p) for p in params], tx=tx,
        ema_params=[jnp.asarray(p) for p in params])
    tp = [_t(p) for p in params]
    ema = [p.clone() for p in tp]
    opt = tcommon.MultiSteps(tcommon.AdamW(tp, tcommon.make_lr_schedule(1e-2, None, None, 10),
                                           1.0, 1e-2, mu_dtype=torch.bfloat16), 2)
    for i in range(6):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        with jax.disable_jit():
            state = state.apply_gradients(grads=[jnp.asarray(g) for g in gs])
            state = state.update_ema(0.9, synced=jcommon.multisteps_synced(state.opt_state))
        before = [e.clone() for e in ema]
        if opt.step([_t(g) for g in gs]):
            tcommon.ema_update(ema, tp, 0.9)
        else:
            assert all(torch.equal(a, b) for a, b in zip(before, ema))
        for a, b in zip(state.ema_params, ema):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-8)


def test_accumulated_train_step_matches_jax_make_train_step():
    """grad_accumulate_step = 2 with EMA, four microsteps: the port's
    train_step against LDMTrainer._make_train_step fed the same draws. The
    loss every step; params and EMA unchanged on the odd microsteps (the
    JAX step adds zero updates); after each synced step the params agree
    as Adam's sign-like update allows: within 2.02 lr an update everywhere,
    and on at least 99% of the elements to 1e-3 lr after the first update
    and 1e-2 lr after the second."""
    from medical_image_generation_tpu.training.train_ldm import LDMTrainer as JLDMTrainer

    cfg = _config(ema_decay=0.9, grad_accumulate_step=2)
    jm, uparams, tm, latent, ddpm_p = tiny_unet_pair(seed=51)
    jvae, vparams, tvae, _ = tiny_vae_pair(seed=52)
    tr = object.__new__(JLDMTrainer)
    tr.config, tr.unet, tr.autoencoder, tr.ae_params = cfg, jm, jvae, vparams
    tr.schedule = JNoiseSchedule.from_config(cfg["time_scheduler_params"])
    tr.latent_space_type, tr.scale_factor, tr.aug_cfg = "vae", 0.7, _jax_aug_cfg(cfg)
    tr.ema_decay, tr.clip, tr.class_cond = 0.9, 1.0, None
    tx = jcommon.make_optimizer(jcommon.make_lr_schedule(LR, None, None, 250), 1.0, 2,
                                weight_decay=1e-2, mu_dtype=jnp.bfloat16)
    state = jcommon.EMATrainState.create(apply_fn=jm.apply, params=uparams, tx=tx,
                                         ema_params=jax.tree_util.tree_map(jnp.copy, uparams))
    step = tr._make_train_step()
    trainer = LDMTrainer(cfg, tm, tvae, device="cpu")
    trainer.scale_factor = 0.7
    assert isinstance(trainer.opt, tcommon.MultiSteps)
    initial = compute_initial_patch_size(cfg["ddpm_transformations"])
    lat = (2, *latent, ddpm_p["in_channels"])
    prev_ref = None
    for i in range(4):
        x = np.random.default_rng(60 + i).uniform(0, 1, (2, *initial, 1)).astype(np.float32)
        rng = jax.random.PRNGKey(70 + i)
        aug_rng, enc_rng, t_rng, n_rng, _ = jax.random.split(rng, 5)
        draws = TrainDraws(
            augment=jax_draws(aug_rng, 2, 1, tr.aug_cfg),
            eps=torch.from_numpy(np.array(jax.random.normal(enc_rng, lat, jnp.float32))),
            t=torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 50))).long(),
            noise=torch.from_numpy(np.array(jax.random.normal(n_rng, lat, jnp.float32))))
        old = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()}
        old_ema = [e.clone() for e in trainer.ema]
        state, jloss = step(state, vparams, jnp.asarray(x), rng)
        loss = trainer.train_step(torch.from_numpy(x), draws=draws)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
        assert trainer.opt.mini_step == int(state.opt_state.mini_step) == (i + 1) % 2
        assert trainer.opt.count == int(state.opt_state.inner_opt_state[1][0].count)
        ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
        ema_ref = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    state.ema_params))
        if i % 2 == 0:
            assert all(torch.equal(p.detach(), old[n])
                       for n, p in trainer.unet.named_parameters())
            assert all(torch.equal(a, b) for a, b in zip(old_ema, trainer.ema))
            if i:
                assert all(torch.equal(ref[n], prev_ref[n]) for n in ref)
            prev_ref = ref
            continue
        # the second update starts from params that already differ (on under
        # 1% of the elements, by up to 2 lr), so its gradients differ a little
        # everywhere: 1e-2 lr then (its 99th percentile read 2e-3 lr)
        n_upd = (i + 1) // 2
        firm = 1e-3 * LR if n_upd == 1 else 1e-2 * LR
        n_off, n_all = 0, 0
        for n, p in trainer.unet.named_parameters():
            d = (p.detach() - ref[n]).abs()
            assert bool((d <= n_upd * 2.02 * LR + 2.0 ** -22 * ref[n].abs()).all()), n
            n_off += int((d > firm + 2.0 ** -22 * ref[n].abs()).sum())
            n_all += d.numel()
        assert n_off <= 0.01 * n_all, (n_off, n_all)
        prev_ref = ref
        sd = dict(zip(trainer.param_names, trainer.ema))
        for n in ema_ref:
            np.testing.assert_allclose(sd[n].numpy(), ema_ref[n].numpy(), rtol=2.0 ** -22,
                                       atol=2 * 2.02 * LR * (1 - 0.9), err_msg=n)


# ------------------------------------------------------------------------ CLI


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    """A preprocessed dataset written with the port's VolStore (6 patients
    of (1, 36, 40, 40), a foreground cube each), the tiny config as the
    planner's medimgen_config.yaml, an AE best_model.pt of seeded weights,
    the env vars, and loaders of 3 train / 2 val steps."""
    pre, res = tmp_path / "pre", tmp_path / "res"
    images = pre / "Task099_Synth" / "imagesTr"
    images.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(6):
        vol = rng.uniform(0, 1, (1, 36, 40, 40)).astype(np.float32)
        write_volume(str(images / f"p{i:03d}.vs"), vol)
        save_properties(str(images), f"p{i:03d}",
                        {"class_locations": {1: [(z, 20, 20) for z in range(10, 26)]}})
    cfg = _config(ddpm_batch_size=2, num_workers=2)
    with open(pre / "Task099_Synth" / "medimgen_config.yaml", "w") as f:
        yaml.safe_dump({"3D": cfg}, f)
    ae = res / "Task099_Synth" / "3d" / "autoencoder" / "checkpoints"
    ae.mkdir(parents=True)
    _, _, tvae, _ = tiny_vae_pair(seed=81)
    torch.save({"epoch": 4, "vae": tvae.state_dict()}, ae / "best_model.pt")
    monkeypatch.setenv("medimgen_preprocessed", str(pre))
    monkeypatch.setenv("medimgen_results", str(res))
    monkeypatch.setattr(train_ldm, "get_data_loaders",
                        functools.partial(tloader.get_data_loaders, train_steps=3, val_steps=2,
                                          num_threads=2))
    return ["099", "train-val-test", "3d", "--device", "cpu", "--dtype", "fp32"]


def _state(tr):
    """Every part of a trainer's state that a resume must restore."""
    return {"params": [p.detach().clone() for p in tr.params],
            "ema": [e.clone() for e in tr.ema], "mu": [m.clone() for m in tr.opt.mu],
            "nu": [v.clone() for v in tr.opt.nu], "acc": [a.clone() for a in tr.opt.acc],
            "count": tr.opt.count, "mini_step": tr.opt.mini_step, "step": tr.step,
            "host": tr.host_generator.get_state(), "device": tr.generator.get_state(),
            "scale_factor": tr.scale_factor}


def _assert_same_state(a, b):
    for k in a:
        if isinstance(a[k], list):
            assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_cli_trains_resumes_bit_for_bit_and_continues(cli_env, monkeypatch):
    """Two epochs (with matplotlib and PIL made unimportable: the interval
    samples go to plots/epoch_2.npy, no loss.png), then -c with n_epochs=2
    restores the saved state bit for bit (params, EMA, mu, nu, the
    mid-accumulation acc and mini_step, count, step, both generators, and
    the train loader's draws: the resumed loader's next epoch equals the
    uninterrupted loader's, although the probe moved it first), the next step of the resumed trainer equals the uninterrupted trainer's,
    from its own draws and from explicit ones, and -c to three epochs runs
    one more epoch onto the same loss history."""
    sets = ["--set", "ema_decay=0.9", "--set", "grad_accumulate_step=4",
            "--set", "val_plot_interval=2"]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        m.setitem(sys.modules, "PIL", None)
        m.setattr(tplots, "_warned", False)
        a = train_ldm.run_cli(cli_env + sets + ["--set", "n_epochs=2"])
    plots_dir, ck = a.save_dict["plots"], a.save_dict["checkpoints"]
    assert sorted(os.listdir(plots_dir)) == ["epoch_2.npy"]
    samples = np.load(os.path.join(plots_dir, "epoch_2.npy"))
    assert samples.shape == (2, 32, 32, 32, 1) and np.isfinite(samples).all()
    assert len(a.loss_dict["rec_loss"]) == 2 and a.step == 6
    assert (a.opt.mini_step, a.opt.count) == (2, 1)
    assert sorted(os.listdir(ck)) == ["best_model.pt", "last_model.pt"]
    saved = tckpt.load_checkpoint(os.path.join(ck, "last_model.pt"))
    assert saved["epoch"] == 1 and saved["opt_state"]["mini_step"] == 2
    assert set(saved) >= {"unet", "ema_unet", "vae", "opt_state", "step", "validation_loss",
                          "scale_factor", "latent_shape", "generators", "train_loader"}

    b = train_ldm.run_cli(cli_env + sets + ["-c", "--set", "n_epochs=2"])
    assert b.start_epoch == 2 and b.epoch_stats == []
    _assert_same_state(_state(a), _state(b))
    for n, p in zip(b.param_names, b.params):
        assert torch.equal(p.detach(), saved["unet"][n])
    assert b.train_loader.state() == saved["train_loader"] == a.train_loader.state()
    for xa, xb in zip(a.train_loader, b.train_loader, strict=True):
        np.testing.assert_array_equal(xa, xb)

    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (2, *compute_initial_patch_size(a.config["ddpm_transformations"]), 1))
        .astype(np.float32))
    la, lb = a.train_step(x), b.train_step(x)  # each from its own generators
    assert torch.equal(la, lb)
    _assert_same_state(_state(a), _state(b))
    draws = a.make_draws(x, generator=torch.Generator().manual_seed(9),
                         host_generator=torch.Generator().manual_seed(10))
    assert torch.equal(a.train_step(x, draws=draws), b.train_step(x, draws=draws))
    _assert_same_state(_state(a), _state(b))
    assert a.opt.count == 2 and a.opt.mini_step == 0

    c = train_ldm.run_cli(cli_env + sets[:4] + ["-c", "--set", "n_epochs=3",
                                                "--set", "val_plot_interval=3"])
    assert c.start_epoch == 2 and len(c.epoch_stats) == 1
    assert c.loss_dict["rec_loss"][:2] == a.loss_dict["rec_loss"]
    assert len(c.loss_dict["val_rec_loss"]) == 3 and c.step == 9
    assert tckpt.load_loss_dict(c.save_path) == c.loss_dict
    assert tckpt.load_checkpoint(os.path.join(ck, "last_model.pt"))["epoch"] == 2
    assert {"epoch_2.npy", "epoch_3.gif", "loss.png"} <= set(os.listdir(plots_dir))


@pytest.mark.parametrize("extra,err", [
    (["--set", "ddpm_transformations.aug_preset=bogus"], (ValueError, "aug_preset")),
    (["--set", "ddpm_params.with_conditioning=true"], (KeyError, "with_conditioning")),
    (["--set", "vae_params.use_convtranspose=true"], (RuntimeError, "ConvTranspose_0")),
    (["--set", "vae_params.num_res_blockz=2"], KeyError),
    (["--set", "latent_space_type=vq"], ValueError),
])
def test_cli_refuses_before_the_first_step(cli_env, monkeypatch, extra, err):
    """A config that disagrees with itself raises at start-up: no train
    step runs and no checkpoint is written. An unknown augmentation preset;
    ``with_conditioning``, which the planner's ddpm_params lacks (``--set``
    changes only keys the YAML holds: write it there first); a transposed-
    conv decoder that the autoencoder's checkpoint was not trained with."""
    monkeypatch.setattr(LDMTrainer, "train_step",
                        lambda *a, **k: pytest.fail("a train step ran"))
    err, match = err if isinstance(err, tuple) else (err, None)
    with pytest.raises(err, match=match):
        train_ldm.run_cli(cli_env + extra)
    assert not os.path.exists(os.path.join(os.environ["medimgen_results"], "Task099_Synth",
                                           "3d", "ldm", "checkpoints", "last_model.pt"))


def test_frozen_autoencoder_ignores_use_checkpointing(cli_env, tmp_path):
    """A planned config with ``vae_params.use_checkpointing: true`` (the
    planner's rematerialisation choice for stage 1) trains the LDM and
    samples: both hold the autoencoder frozen, with no backward pass
    through it, so only the stage-1 trainer refuses the key."""
    ldm = train_ldm.run_cli(cli_env + ["--set", "vae_params.use_checkpointing=true",
                                       "--set", "n_epochs=1", "--set", "val_plot_interval=5"])
    assert ldm.config["vae_params"]["use_checkpointing"] is True
    assert len(ldm.loss_dict["rec_loss"]) == 1 and np.isfinite(ldm.loss_dict["rec_loss"][0])
    cfg_path = os.path.join(ldm.save_path, "config.yaml")
    with open(cfg_path) as f:
        assert yaml.safe_load(f)["vae_params"]["use_checkpointing"] is True
    out = tmp_path / "samples"
    tsample.main_ldm([cfg_path, os.path.join(ldm.save_dict["checkpoints"], "best_model.pt"),
                      "-n", "1", "--num_inference_steps", "2", "--dtype", "fp32",
                      "--device", "cpu", "-o", str(out)])
    vol = load_nifti(str(out / "ldm_sample_000.nii.gz")).data
    assert vol.shape == (32, 32, 32) and np.isfinite(vol).all()


def test_sampling_cli_samples_the_live_params_not_the_ema(tmp_path, monkeypatch):
    """Two tiny steps with EMA on, then save_checkpoint: the .pt carries the
    live params under ``unet`` and the EMA under ``ema_unet``, and
    medimgen_torch_sample_ldm builds its U-Net from the live params, as the
    JAX sampling CLI samples ``params`` (training/sample.py:89-95)."""
    cfg = _config(ema_decay=0.5)
    _, _, tvae, _ = tiny_vae_pair(seed=91)
    trainer = LDMTrainer.from_config(cfg, tvae.state_dict(), device="cpu",
                                     dtype=torch.float32, seed=2)
    x = torch.rand((2, *compute_initial_patch_size(cfg["ddpm_transformations"]), 1),
                   generator=torch.Generator().manual_seed(1))
    trainer.probe_latent(x)
    for _ in range(2):
        trainer.train_step(x)
    live = {n: p.detach().clone() for n, p in zip(trainer.param_names, trainer.params)}
    ema = dict(zip(trainer.param_names, trainer.ema))
    assert any(not torch.equal(live[n], ema[n]) for n in live)
    path = tmp_path / "ldm.pt"
    trainer.save_checkpoint(str(path))
    payload = torch.load(path, weights_only=True)
    assert all(torch.equal(payload["unet"][n], live[n]) for n in live)
    assert all(torch.equal(payload["ema_unet"][n], ema[n]) for n in live)
    seen = {}
    orig = LDMSampler.from_config

    def spy(config, unet_state, *a, **k):
        seen["unet"] = unet_state
        return orig(config, unet_state, *a, **k)

    monkeypatch.setattr(tsample.LDMSampler, "from_config", staticmethod(spy))
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    tsample.main_ldm([str(tmp_path / "config.yaml"), str(path), "-n", "1",
                      "--num_inference_steps", "1", "--dtype", "fp32", "--device", "cpu",
                      "-o", str(tmp_path / "out")])
    assert all(torch.equal(seen["unet"][n], live[n]) for n in live)
    with trainer.sampling_weights() as unet:  # the in-loop samples use the EMA
        assert all(torch.equal(p.detach(), ema[n]) for n, p in unet.named_parameters())
    assert all(torch.equal(p.detach(), live[n]) for n, p in trainer.unet.named_parameters())


# --------------------------------------------------------------------- bridge


def test_orbax_bridge_feeds_the_port_sampler(tmp_path):
    """A tiny JAX AE and LDM checkpoint (orbax) through tools/orbax_to_torch.py:
    the AE .pt is what the training CLI reads; the LDM .pt (with --vae)
    samples through LDMSampler as the JAX sample_images does on the same
    checkpoint, fed the same draws, in fp32."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import orbax_to_torch

    jm, uparams, _, latent, ddpm_p = tiny_unet_pair(seed=61)
    jvae, vparams, _, vae_p = tiny_vae_pair(seed=62)
    ema = jax.tree_util.tree_map(lambda v: v * 0.5, uparams)
    shape = [2, *latent, ddpm_p["in_channels"]]
    jckpt.save_checkpoint(str(tmp_path / "ae"), "best_model", {"epoch": 3, "g_params": vparams})
    jckpt.save_checkpoint(str(tmp_path / "ldm"), "best_model",
                          {"epoch": 5, "params": uparams, "ema_params": ema,
                           "scale_factor": 0.8, "latent_shape": shape})
    ae_pt, ldm_pt = str(tmp_path / "ae.pt"), str(tmp_path / "ldm.pt")
    orbax_to_torch.main([str(tmp_path / "ae" / "best_model"), ae_pt])
    orbax_to_torch.main([str(tmp_path / "ldm" / "best_model"), ldm_pt,
                         "--vae", str(tmp_path / "ae" / "best_model")])
    ae = torch.load(ae_pt, weights_only=True)
    assert ae["epoch"] == 3 and set(ae) == {"epoch", "vae"}
    payload = tsample.load_torch_checkpoint(ldm_pt)
    assert payload["epoch"] == 5 and payload["latent_shape"] == shape
    want_ema = convert.unet_from_flax(jax.tree_util.tree_map(np.asarray, ema))
    assert all(torch.equal(payload["ema_unet"][k], v) for k, v in want_ema.items())
    assert all(torch.equal(payload["vae"][k], v) for k, v in ae["vae"].items())

    T, steps = 1000, 3
    tr, state = _jax_sampling_trainer(jm, uparams, jvae, vparams, JNoiseSchedule.create(T),
                                      0.8, tuple(shape))
    rng = jax.random.PRNGKey(6)
    ref = tr.sample_images(state, 2, rng, sampler="ddim", num_inference_steps=steps)
    carry, init = jax.random.split(rng)
    x_T = torch.from_numpy(np.array(jax.random.normal(init, tuple(shape))))
    config = {"vae_params": vae_p, "ddpm_params": ddpm_p,
              "time_scheduler_params": {"num_train_timesteps": T}}
    sampler = LDMSampler.from_config(config, payload["unet"], payload["vae"],
                                     payload["scale_factor"], payload["latent_shape"],
                                     dtype=torch.float32, device="cpu")
    got = sampler.sample(2, sampler="ddim", num_inference_steps=steps, x_T=x_T)
    np.testing.assert_allclose(got, ref, **TRAJ_TOL)


def test_port_imports_no_optional_host_packages():
    """Every port module loads without importing sklearn, matplotlib, PIL,
    tqdm or zarr beyond what torch itself imports: a GPU host running the
    port need not have them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy, torch, yaml\n"
        "base = set(sys.modules)\n"
        "import medical_image_generation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in set(sys.modules) - base if n.split('.')[0] in "
        "('sklearn', 'matplotlib', 'PIL', 'tqdm', 'zarr'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
