"""PyTorch port, the stage-1 CLI: ``medimgen_torch_train_autoencoder`` on
the CPU at the tiny config (an epoch with the adversarial loss off, an
epoch with it on, last / best / ``loss_dict.pkl``, a ``-c`` resume bit for
bit, the train loader's draws included), then ``medimgen_torch_train_ldm``
and ``medimgen_torch_sample_ldm`` on the port-written ``best_model.pt``,
for ``-l vae`` and ``-l vq``; what the trainer refuses before its first
step; and the orbax -> ``.pt`` bridge for a VQ run and its
discriminator."""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from medical_image_generation_tpu.training import checkpoints as jckpt
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.data import loader as tloader
from medical_image_generation_tpu_torch.data.patches import compute_initial_patch_size
from medical_image_generation_tpu_torch.io.nifti import load_nifti
from medical_image_generation_tpu_torch.io.volstore import write_volume
from medical_image_generation_tpu_torch.planning.preprocess import save_properties
from medical_image_generation_tpu_torch.training import checkpoints as tckpt
from medical_image_generation_tpu_torch.training import sample as tsample
from medical_image_generation_tpu_torch.training import train_autoencoder, train_ldm
from medical_image_generation_tpu_torch.training.train_autoencoder import AutoEncoderTrainer
from test_torch_autoencoder import disc_pair, vq_pair
from test_torch_train_ae import ae_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ae_env(tmp_path, monkeypatch):
    """A preprocessed dataset written with the port's VolStore (6 patients
    of (1, 36, 40, 40)), the tiny stage-1 config as the planner's
    medimgen_config.yaml (with the probe's ``remat_policy``), the env vars,
    and loaders of 3 train / 2 val steps for both trainers."""
    pre, res = tmp_path / "pre", tmp_path / "res"
    images = pre / "Task099_Synth" / "imagesTr"
    images.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(6):
        vol = rng.uniform(0, 1, (1, 36, 40, 40)).astype(np.float32)
        write_volume(str(images / f"p{i:03d}.vs"), vol)
        save_properties(str(images), f"p{i:03d}",
                        {"class_locations": {1: [(z, 20, 20) for z in range(10, 26)]}})
    cfg = ae_config(ae_batch_size=2, ddpm_batch_size=2, num_workers=2, kl_weight=1e-7,
                    adv_weight=0.01)
    # remat_policy as the planner writes it after its memory probe
    cfg["vae_params"] = dict(cfg["vae_params"], remat_policy="acts")
    with open(pre / "Task099_Synth" / "medimgen_config.yaml", "w") as f:
        yaml.safe_dump({"3D": cfg}, f)
    monkeypatch.setenv("medimgen_preprocessed", str(pre))
    monkeypatch.setenv("medimgen_results", str(res))
    loaders = functools.partial(tloader.get_data_loaders, train_steps=3, val_steps=2,
                                num_threads=2)
    monkeypatch.setattr(train_autoencoder, "get_data_loaders", loaders)
    monkeypatch.setattr(train_ldm, "get_data_loaders", loaders)
    return ["099", "train-val-test", "3d", "--device", "cpu", "--dtype", "fp32"]


def _state(tr):
    """Every part of an AE trainer's state that a resume must restore."""
    out = {"g": [p.detach().clone() for p in tr.g_params],
           "d": [p.detach().clone() for p in tr.d_params],
           "step": tr.step, "kl_weight": tr.kl_weight,
           "host": tr.host_generator.get_state(), "device": tr.generator.get_state(),
           "loader": tr.train_loader.state()}
    for name, opt in (("g_opt", tr.g_opt), ("d_opt", tr.d_opt)):
        out[name] = ([m.clone() for m in opt.mu], [v.clone() for v in opt.nu], opt.count)
    return out


def _assert_same(a, b):
    for k in a:
        if k in ("g", "d"):
            assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
        elif k in ("g_opt", "d_opt"):
            for xs, ys in zip(a[k][:2], b[k][:2]):
                assert all(torch.equal(x, y) for x, y in zip(xs, ys)), k
            assert a[k][2] == b[k][2], k
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_ae_cli_trains_resumes_bit_for_bit_and_feeds_the_ldm(ae_env, tmp_path):
    """Epoch 1 without, epoch 2 with the adversarial loss; the payload's
    keys; -c restores the state bit for bit (both networks, both Adam
    states, step, kl_weight, both generators and the train loader's draws)
    and the next step of the resumed trainer equals the uninterrupted
    one's; medimgen_torch_train_ldm then trains on best_model.pt's vae, and
    medimgen_torch_sample_ldm samples its checkpoint."""
    sets = ["--set", "autoencoder_warm_up_epochs=1", "--set", "val_plot_interval=1"]
    a = train_autoencoder.run_cli(ae_env + sets + ["--set", "n_epochs=2"])
    assert [s["adv_on"] for s in a.epoch_stats] == [False, True]
    ld = a.loss_dict
    assert len(ld["train_rec"]) == len(ld["val_rec"]) == len(ld["lr"]) == 2
    assert ld["gen_adv"][0] == ld["disc"][0] == 0.0 and ld["gen_adv"][1] > 0 < ld["disc"][1]
    assert all(np.isfinite(v) for k in ld for v in ld[k])
    assert a.step == 6 and a.g_opt.count == 6 and a.d_opt.count == 3
    ck = a.save_dict["checkpoints"]
    assert sorted(os.listdir(ck)) == ["best_model.pt", "last_model.pt"]
    assert tckpt.load_loss_dict(a.save_path) == ld
    assert {"epoch_1.gif", "epoch_2.gif", "loss.png", "all_losses.png"} <= set(
        os.listdir(a.save_dict["plots"]))
    saved = tckpt.load_checkpoint(os.path.join(ck, "last_model.pt"))
    assert saved["epoch"] == 1 and saved["g_opt_state"]["count"] == 6
    assert set(saved) == {"epoch", "vae", "discriminator", "g_opt_state", "d_opt_state",
                          "step", "validation_loss", "kl_weight", "generators", "train_loader"}

    b = train_autoencoder.run_cli(ae_env + sets + ["-c", "--set", "n_epochs=2"])
    assert b.start_epoch == 2 and b.epoch_stats == [] and b.resumed
    _assert_same(_state(a), _state(b))
    assert all(torch.equal(v, saved["vae"][k]) for k, v in b.model.state_dict().items())
    for xa, xb in zip(a.train_loader, b.train_loader, strict=True):
        np.testing.assert_array_equal(xa, xb)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (2, *compute_initial_patch_size(a.config["ae_transformations"]), 1))
        .astype(np.float32))
    ma, mb = a.train_step(x, True), b.train_step(x, True)  # each from its own generators
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    _assert_same(_state(a), _state(b))

    best = tckpt.load_checkpoint(os.path.join(ck, "best_model.pt"))
    ldm = train_ldm.run_cli(ae_env + ["--set", "n_epochs=1", "--set", "val_plot_interval=5"])
    assert all(torch.equal(v, best["vae"][k]) for k, v in ldm.vae.state_dict().items())
    assert len(ldm.loss_dict["rec_loss"]) == 1 and np.isfinite(ldm.loss_dict["rec_loss"][0])
    out = tmp_path / "samples"
    tsample.main_ldm([os.path.join(ldm.save_path, "config.yaml"),
                      os.path.join(ldm.save_dict["checkpoints"], "best_model.pt"), "-n", "1",
                      "--num_inference_steps", "2", "--dtype", "fp32", "--device", "cpu",
                      "-o", str(out)])
    vol = load_nifti(str(out / "ldm_sample_000.nii.gz")).data
    assert vol.shape == (32, 32, 32) and np.isfinite(vol).all()


def test_vq_autoencoder_then_ldm_vq(ae_env, tmp_path):
    """-l vq through both trainers: the AE epoch (adversarial loss on from
    the start) writes ``vq``; the LDM takes its codebook range, trains on
    the VQ latent (scale_factor stays 1) and samples through the
    quantizer."""
    ae = train_autoencoder.run_cli(ae_env + ["-l", "vq", "--set", "n_epochs=1",
                                             "--set", "autoencoder_warm_up_epochs=0"])
    assert ae.epoch_stats[0]["adv_on"] and ae.loss_dict["disc"][0] > 0
    best = tckpt.load_checkpoint(os.path.join(ae.save_dict["checkpoints"], "best_model.pt"))
    assert "vq" in best and "vae" not in best
    with pytest.raises(KeyError, match="'vae'"):
        train_ldm.run_cli(ae_env + ["--set", "n_epochs=1"])
    ldm_sets = ["--set", "ddpm_params.in_channels=8", "--set", "ddpm_params.out_channels=8",
                "--set", "n_epochs=1", "--set", "val_plot_interval=5"]
    ldm = train_ldm.run_cli(ae_env + ["-l", "vq", "-c"] + ldm_sets)
    cb = best["vq"]["quantizer.codebook"]
    assert (ldm.codebook_min, ldm.codebook_max) == (float(cb.min()), float(cb.max()))
    assert ldm.scale_factor == 1.0 and ldm.latent_shape == (2, 16, 16, 16, 8)
    assert np.isfinite(ldm.loss_dict["rec_loss"][0])
    payload = tckpt.load_checkpoint(os.path.join(ldm.save_dict["checkpoints"], "best_model.pt"))
    assert "vq" in payload and "vae" not in payload
    out = tmp_path / "samples"
    tsample.main_ldm([os.path.join(ldm.save_path, "config.yaml"),
                      os.path.join(ldm.save_dict["checkpoints"], "best_model.pt"), "-n", "1",
                      "--num_inference_steps", "2", "--dtype", "fp32", "--device", "cpu",
                      "-o", str(out)])
    vol = load_nifti(str(out / "ldm_sample_000.nii.gz")).data
    assert vol.shape == (32, 32, 32) and np.isfinite(vol).all()


@pytest.mark.parametrize("extra,err", [
    (["--set", "vae_params.use_checkpointing=true", "--set", "vae_params.remat_policy=bogus"],
     ValueError),
    (["--set", "ae_transformations.aug_preset=bogus"], ValueError),
    (["--set", "latent_space_type=vq"], ValueError),
    (["--set", "vae_params.num_res_blockz=2"], KeyError),
])
def test_ae_cli_refuses_before_the_first_step(ae_env, monkeypatch, extra, err):
    monkeypatch.setattr(AutoEncoderTrainer, "train_step",
                        lambda *a, **k: pytest.fail("a train step ran"))
    with pytest.raises(err):
        train_autoencoder.run_cli(ae_env + extra)
    assert not os.path.exists(os.path.join(os.environ["medimgen_results"], "Task099_Synth",
                                           "3d", "autoencoder", "checkpoints"))


def test_ae_trainer_refuses_cpu_fallback(ae_env, monkeypatch):
    """Without --device the CLI asks for CUDA and raises when there is none;
    it never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_autoencoder.run_cli(ae_env[:3])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutoEncoderTrainer.from_config(ae_config())


def test_orbax_bridge_converts_a_vq_run_and_its_discriminator(tmp_path):
    """tools/orbax_to_torch.py on a JAX AE checkpoint of a VQ run with its
    discriminator: ``vq`` and ``discriminator`` state_dicts equal to the
    converters' output, which load into the port's modules."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import orbax_to_torch

    _, gparams, vq, _ = vq_pair(seed=131)
    _, dparams, disc, _ = disc_pair(seed=132)
    jckpt.save_checkpoint(str(tmp_path / "ae"), "best_model",
                          {"epoch": 7, "g_params": gparams, "d_params": dparams})
    out = str(tmp_path / "ae.pt")
    orbax_to_torch.main([str(tmp_path / "ae" / "best_model"), out])
    ae = torch.load(out, weights_only=True)
    assert set(ae) == {"epoch", "vq", "discriminator"} and ae["epoch"] == 7
    want = convert.vae_from_flax(jax.tree_util.tree_map(np.asarray, gparams))
    assert all(torch.equal(ae["vq"][k], v) for k, v in want.items())
    vq.load_state_dict(ae["vq"])
    disc.load_state_dict(ae["discriminator"])
