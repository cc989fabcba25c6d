"""The plain reference against the program's plain path (its CPU versions of
the kernels) at the tiny test geometry, in float32 on the CPU: one run of
the harness, whose output check compares the program's first three training
steps with the reference's."""

import io
import json
import os

import pytest
import torch

from benchmark import harness
from benchmark.reference import augment, ldm, nets

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
SPEC = os.path.join(DATA, "BENCHMARK.json")
DIRS = [DATA, harness.BENCH_DIR]


def tiny_run(seed=7, workload="tiny3d_train", **kw):
    out = io.StringIO()
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5"],
                      spec_path=SPEC, dirs=DIRS, require_card=False, out=out, **kw)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_training_steps_match_the_program_on_cpu():
    """One LDM run: the program's first three steps against the reference's."""
    rc, line = tiny_run(seed=2 ** 33 + 5)
    assert rc == 0
    assert line["correct"], line["checks"]
    assert line["checks"]["grad_gap"]["value"] < 1e-3
    assert line["checks"]["change_gap"]["value"] < 1e-2
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"train_step_ms", "peak_mem_gib", "setup_s"}


def test_reference_unet_matches_the_program_unet():
    from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet

    from benchmark import traffic

    cfg = harness.load_json(os.path.join(DATA, "configs", "tiny3d.json"))["config"]
    ref = nets.UNet(cfg["ddpm_params"])
    w = traffic.weights(ldm.named_shapes(ref), nets.norm_weights(ref), 3, 0, "cpu")
    ref = ldm.load(ref, w)
    prog = DiffusionUNet.from_config(cfg["ddpm_params"], dtype=torch.float32, device="cpu")
    prog.load_state_dict(w)
    x = torch.randn(2, 16, 16, 16, 4)
    t = torch.tensor([3, 900])
    got = prog(x, t)
    want = ref(x.movedim(-1, 1), t).movedim(1, -1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale_on", [False, True])
def test_reference_augmentation_matches_the_program(scale_on):
    from medical_image_generation_tpu_torch.data.augment import (
        AugmentConfig,
        AugmentDraws,
        augment_batch,
    )

    work = harness.load_json(os.path.join(DATA, "workloads", "tiny3d_train.json"))
    aug = work["augment"]
    B = 2
    x = torch.rand(B, 32, 36, 36, 1)
    on = torch.full((B,), True)
    d = dict(scale_on=torch.full((B,), scale_on), scale=torch.tensor([0.93, 1.07]),
             flips=torch.tensor([[True], [False]]), bright_on=on,
             bright=torch.tensor([[1.05], [0.95]]), contrast_on=on,
             contrast=torch.tensor([[0.92], [1.08]]), gamma_on=on,
             gamma=torch.tensor([[1.04], [0.96]]))
    cfg = AugmentConfig(rotation=False, crop_to=tuple(aug["crop_to"]),
                        mirror_axes=tuple(aug["mirror_axes"]), rot_range=0.0)
    pd = AugmentDraws(rot_on=torch.zeros(B, dtype=torch.bool), angle=torch.zeros(B), **d)
    torch.testing.assert_close(augment.augment(x, d, aug), augment_batch(x, pd, cfg))
