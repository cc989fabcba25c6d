"""The MAISI cell's pieces on the CPU: the reference's operation count at the
published widths, one run of the new driver at the tiny width (the program
against the reference), the planted faults, and the span metric."""

import io
import json
import os
from types import SimpleNamespace

import pytest

from benchmark import harness, rooflines
from benchmark.reference import maisi
from benchmark.tests.test_bench_reference import DATA, DIRS
from benchmark.tests.test_bench_spans import Event, metric, r_of
from medical_image_generation_tpu_torch.utils import profiling

BENCH = harness.BENCH_DIR


def _cell_files():
    cfg = harness.load_json(os.path.join(BENCH, "configs", "maisi_ct3d.json"))["config"]
    return cfg, harness.load_json(os.path.join(BENCH, "workloads", "maisi3d_train.json"))


def test_the_count_at_the_published_widths():
    """22 attention calls (11 forward, 11 backward) of 8 heads over 32^3
    tokens and 16 over 16^3, head dim 32: 17.1 TFLOP of the step's 64.2."""
    from benchmark.drivers import ldm_latent_train

    cfg, work = _cell_files()
    got = ldm_latent_train.flop_count(SimpleNamespace(cfg=cfg, work=work))
    att = got["attention"]
    assert len(att) == 22
    fwd = {(8, 32768): 5, (16, 4096): 6}
    want = [f for (H, S), n in fwd.items() for f in [4 * H * S * S * 32] * n]
    assert sorted(f for f, _ in att[::2]) == sorted(want)  # forward, backward in turn
    assert [f for f, _ in att[1::2]] == [2 * f for f, _ in att[::2]]
    assert sum(f for f, _ in att) == pytest.approx(17.11e12, rel=1e-3)
    assert got["flops"] == pytest.approx(64.22e12, rel=1e-3)
    assert len(got["groupnorm"]) == 112
    unet = maisi.UNet(cfg["ddpm_params"])
    assert {(m.heads, m.Dense_1.in_features // m.heads) for m in unet.modules()
            if isinstance(m, maisi.AttentionBlock)} == {(8, 32), (16, 32)}
    peak = rooflines.peaks("NVIDIA H100 80GB HBM3")
    assert rooflines.bound_s(att, peak) == pytest.approx(17.30e-3, rel=1e-3)


def test_chunked_attention_matches_the_whole():
    import torch

    q, k, v = (torch.randn(1, 2, 50, 8, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    torch.testing.assert_close(maisi.chunked_attention(q, k, v, score_elems=2 * 50 * 7),
                               maisi.nets.attention(q, k, v), rtol=1e-6, atol=1e-6)


@pytest.fixture
def tiny(tmp_path):
    """A spec holding the tests' tiny cell and the tiny MAISI cell."""
    spec = harness.load_json(os.path.join(DATA, "BENCHMARK.json"))
    spec["configs"].append({"name": "tiny_maisi", "source": "tests",
                            "file": os.path.join(DATA, "configs", "tiny_maisi.json"),
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "tiny_maisi_train", "config": "tiny_maisi",
                              "traffic": "tiny_maisi_train", "chips": 1, "why": "tests"})
    for c in spec["configs"]:
        c["file"] = os.path.join(DATA, c["file"])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return str(path)


def _run(spec_path, seed, fault=None):
    if fault is None:
        out = io.StringIO()
        rc = harness.main(["--workload", "tiny_maisi_train", "--seed", str(seed), "--seconds",
                           "0.3"], spec_path=spec_path, dirs=DIRS, require_card=False, out=out)
        assert rc == 0
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        return line["correct"], {k: c["value"] for k, c in line["checks"].items()}
    spec = harness.load_json(spec_path)
    cell, driver, _ = harness.load_cell(spec, spec_path, DIRS, "tiny_maisi_train", seed, 0,
                                        False, require_card=False)
    checks = driver.run(cell, fault=driver.FAULTS[fault])["checks"]
    return (all(c["value"] <= c["limit"] for c in checks.values() if c["limit"] is not None),
            {k: c["value"] for k, c in checks.items()})


def test_the_driver_follows_the_program_on_cpu(tiny):
    correct, checks = _run(tiny, 2 ** 35 + 17)
    assert correct, checks
    assert checks["grad_gap"] < 1e-4 and checks["attn_qk_gap"] < 1e-4


@pytest.mark.parametrize("fault", ["heads_merged", "cond_dropped", "unchanged"])
def test_a_planted_fault_changes_the_numbers(tiny, fault):
    correct, checks = _run(tiny, 2 ** 35 + 17, fault)
    assert not correct, checks
    key = {"heads_merged": "attn_qk_gap", "cond_dropped": "temb_grad_gap",
           "unchanged": "change_gap"}[fault]
    assert checks[key] > 1e-2


def test_the_float8_control_fails_at_the_tiny_size(tiny):
    spec = harness.load_json(tiny)
    cell, driver, _ = harness.load_cell(spec, tiny, DIRS, "tiny_maisi_train", 21, 0, False,
                                        require_card=False)
    checks = driver.follow_control(cell)
    assert any(c["limit"] is not None and c["value"] > c["limit"] for c in checks.values())


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def test_attention_span_metric(recorder, monkeypatch):
    read = metric("attn_fwd_ms.maisi3d")
    assert read(r_of(2)) is None
    for i in range(2):
        for j in range(3):  # three blocks of 2 ms a step
            recorder.spans.append(profiling.SpanRecord(
                "medimgen.attention", "medimgen.unet_forward", i, i + 0.1,
                (Event(10.0 * j), Event(10.0 * j + 2))))
        recorder.spans.append(profiling.SpanRecord("medimgen.train_step", None, i, i + 0.2,
                                                    (Event(0.0), Event(50.0))))
    assert read(r_of(2)) == pytest.approx(6.0)
    assert read(r_of(3)) is None
    monkeypatch.delattr(profiling, "read")
    assert read(r_of(2)) is None
