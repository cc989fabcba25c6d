"""PyTorch port, the planner's 2D configuration through the CLIs on the
CPU: ``medimgen_torch_train_ldm`` runs the generative eval at the interval
by default (the start-up refusal is gone), and the 2D chain
``medimgen_torch_train_autoencoder`` -> ``medimgen_torch_train_ldm`` ->
``-c`` -> ``medimgen_torch_sample_ldm`` writes and reads PNGs. fp32, tiny
2D config (32^2 slices of small volumes)."""

import functools
import os

import numpy as np
import pytest
import torch
import yaml

from medical_image_generation_tpu_torch.data import loader as tloader
from medical_image_generation_tpu_torch.io import png as tpng
from medical_image_generation_tpu_torch.io.volstore import write_volume
from medical_image_generation_tpu_torch.planning.preprocess import save_properties
from medical_image_generation_tpu_torch.training import checkpoints as tckpt
from medical_image_generation_tpu_torch.training import sample as tsample
from medical_image_generation_tpu_torch.training import train_autoencoder, train_ldm
from test_torch_2d import config_2d
from torch_parity import tiny_vae_pair


@pytest.fixture
def cli_env_2d(tmp_path, monkeypatch):
    """A preprocessed dataset of 6 patients of (1, 12, 40, 40) that the 2D
    loaders cut 32^2 slices from, the tiny 2D config (narrow discriminator,
    two-stage perceptual plan) as the planner's medimgen_config.yaml, the
    env vars, and loaders of 3 train / 2 val steps for both trainers."""
    pre, res = tmp_path / "pre", tmp_path / "res"
    images = pre / "Task099_Synth" / "imagesTr"
    images.mkdir(parents=True)
    rng = np.random.default_rng(2)
    for i in range(6):
        write_volume(str(images / f"p{i:03d}.vs"),
                     rng.uniform(0, 1, (1, 12, 40, 40)).astype(np.float32))
        save_properties(str(images), f"p{i:03d}",
                        {"class_locations": {1: [(z, 20, 20) for z in range(2, 10)]}})
    cfg = config_2d(ae_batch_size=2, ddpm_batch_size=4, num_workers=2)
    cfg["discriminator_params"] = dict(cfg["discriminator_params"], num_channels=8)
    cfg["perceptual_params"] = dict(cfg["perceptual_params"], feature_plan=[[8, 1], [16, 1]])
    with open(pre / "Task099_Synth" / "medimgen_config.yaml", "w") as f:
        yaml.safe_dump({"2D": cfg}, f)
    monkeypatch.setenv("medimgen_preprocessed", str(pre))
    monkeypatch.setenv("medimgen_results", str(res))
    loaders = functools.partial(tloader.get_data_loaders, train_steps=3, val_steps=2,
                                num_threads=2)
    monkeypatch.setattr(train_ldm, "get_data_loaders", loaders)
    monkeypatch.setattr(train_autoencoder, "get_data_loaders", loaders)
    return ["099", "train-val-test", "2d", "--device", "cpu", "--dtype", "fp32"]


def test_2d_ldm_cli_runs_the_generation_eval_by_default(cli_env_2d, capsys):
    """With the planner's 2D config and ``run_generation_eval`` unset,
    medimgen_torch_train_ldm scores the model at the interval: 100 samples
    (here 2 DDIM steps, through the ``eval_sampler`` /
    ``eval_num_inference_steps`` keys, to keep the CPU run short; the
    default protocol is held by ``tests/test_torch_eval.py``), FID,
    MS-SSIM and SSIM over C(100, 2) = 4950 pairs (and MMD with
    ``eval_mmd``), printed as the JAX loop prints them and kept in
    ``epoch_stats``."""
    ae = os.path.join(os.environ["medimgen_results"], "Task099_Synth", "2d", "autoencoder",
                      "checkpoints")
    os.makedirs(ae)
    _, _, tvae, _ = tiny_vae_pair(seed=95, spatial_dims=2)
    torch.save({"epoch": 1, "vae": tvae.state_dict()}, os.path.join(ae, "best_model.pt"))
    tr = train_ldm.run_cli(cli_env_2d + ["--set", "n_epochs=1", "--set", "val_plot_interval=1",
                                         "--set", "eval_mmd=true", "--set", "eval_sampler=ddim",
                                         "--set", "eval_num_inference_steps=2"])
    assert "run_generation_eval" not in tr.config
    out = capsys.readouterr().out
    m = tr.epoch_stats[0]["eval"]
    assert m["n_pairs"] == 4950 and "(4950 pairs)" in out and f"FID: {m['fid']:.4f}" in out
    assert all(np.isfinite(m[k]) for k in ("fid", "ssim", "ms_ssim", "ssim_std", "mmd"))
    assert 0 < m["ms_ssim"] <= 1 and m["fid"] > 0
    assert set(m["seconds"]) == {"sampling", "features", "fid", "pairwise", "mmd"}
    assert os.path.exists(os.path.join(tr.save_dict["plots"], "epoch_1.png"))
    assert tr._extractor is not None and tr._extractor.spatial_dims == 2


def test_2d_autoencoder_ldm_and_sampling_clis_write_pngs(cli_env_2d, tmp_path):
    """The 2D chain: medimgen_torch_train_autoencoder (its interval
    reconstruction a PNG pair), medimgen_torch_train_ldm on its
    best_model.pt (eval off, the 16-sample interval grid a PNG), a -c
    resume to a second epoch restoring the state bit for bit, then
    medimgen_torch_sample_ldm writing one PNG a sample and the grid, read
    back."""
    a = train_autoencoder.run_cli(cli_env_2d + ["--set", "n_epochs=1",
                                                "--set", "val_plot_interval=1"])
    rec = tpng.read_png(os.path.join(a.save_dict["plots"], "epoch_1.png"))
    assert rec.shape == (32, 2 * 32 + 2)
    sets = ["--set", "run_generation_eval=false", "--set", "val_plot_interval=1"]
    l1 = train_ldm.run_cli(cli_env_2d + sets + ["--set", "n_epochs=1"])
    best = tckpt.load_checkpoint(os.path.join(a.save_dict["checkpoints"], "best_model.pt"))
    assert all(torch.equal(v, best["vae"][k]) for k, v in l1.vae.state_dict().items())
    assert "eval" not in l1.epoch_stats[0] and l1.latent_shape == (4, 16, 16, 4)
    grid = tpng.read_png(os.path.join(l1.save_dict["plots"], "epoch_1.png"))
    assert grid.shape == (4 * 32 + 6, 4 * 32 + 6)
    l2 = train_ldm.run_cli(cli_env_2d + sets + ["-c", "--set", "n_epochs=2"])
    assert l2.start_epoch == 1 and len(l2.loss_dict["rec_loss"]) == 2
    saved = tckpt.load_checkpoint(os.path.join(l2.save_dict["checkpoints"], "last_model.pt"))
    assert saved["epoch"] == 1 and saved["step"] == l2.step == 2 * l1.step
    out = tmp_path / "samples"
    tsample.main_ldm([os.path.join(l2.save_path, "config.yaml"),
                      os.path.join(l2.save_dict["checkpoints"], "best_model.pt"), "-n", "3",
                      "--num_inference_steps", "2", "--dtype", "fp32", "--device", "cpu",
                      "-o", str(out)])
    assert sorted(os.listdir(out)) == ["ldm_sample_000.png", "ldm_sample_001.png",
                                       "ldm_sample_002.png", "ldm_sample_grid.png"]
    assert all(tpng.read_png(str(out / f"ldm_sample_00{i}.png")).shape == (32, 32)
               for i in range(3))
    assert tpng.read_png(str(out / "ldm_sample_grid.png")).shape == (32, 3 * 32 + 4)
