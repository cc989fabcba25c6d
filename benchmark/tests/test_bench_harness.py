"""The harness is driven by data; it loads no JAX; it refuses to run without
the card; the output check refuses planted faults and the float8 control."""

import io
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import faults, harness
from benchmark.tests.test_bench_reference import DATA, DIRS, SPEC, tiny_run

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_and_units():
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "workloads", w["name"] + ".json"))
        assert len(w["why"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics", m["name"] + ".py"))


def test_a_cell_a_config_and_a_metric_are_added_as_files(tmp_path):
    extra = tmp_path / "extra"
    for sub in ("configs", "workloads", "metrics"):
        (extra / sub).mkdir(parents=True)
    shutil.copy(os.path.join(DATA, "configs", "tiny3d.json"), extra / "configs" / "tiny3e.json")
    work = harness.load_json(os.path.join(DATA, "workloads", "tiny3d_train.json"))
    work["config"], work["batch"] = "tiny3e", 2
    (extra / "workloads" / "tiny3e_train.json").write_text(json.dumps(work))
    (extra / "metrics" / "steps_seen.train.py").write_text(
        "def read(r):\n    return float(r.trace['steps'])\n")
    spec = harness.load_json(SPEC)
    spec["configs"].append({"name": "tiny3e", "source": "tests", "file": "configs/tiny3e.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "tiny3e_train", "config": "tiny3e",
                              "traffic": "tiny3e_train", "chips": 1, "why": "tests"})
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "train_step_ms"})
    (extra / "BENCHMARK.json").write_text(json.dumps(spec))
    dirs = [str(extra)] + DIRS
    cell, driver, _ = harness.load_cell(spec, str(extra / "BENCHMARK.json"), dirs,
                                        "tiny3e_train", 1, 0.1, False, require_card=False)
    assert cell.work["batch"] == 2 and cell.cfg["ddpm_params"]["num_channels"] == [8, 16, 16]
    metric = harness.load_module(harness.find(dirs, "metrics", "steps_seen.train", ".py"), "m")
    assert metric.read(type("R", (), {"trace": {"steps": 3}})) == 3.0
    out = io.StringIO()
    rc = harness.main(["--workload", "tiny3e_train", "--seed", "11", "--seconds", "0.2"],
                      spec_path=str(extra / "BENCHMARK.json"), dirs=dirs, require_card=False,
                      out=out)
    assert rc == 0 and json.loads(out.getvalue())["correct"]


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints nothing on its
    standard output: it never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                        "--workload", "ldm3d_train", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


_PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(body):
    p = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT, body=body)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    body = ("from benchmark import harness\n"
            f"harness.main(['--workload', 'tiny3d_train', '--seed', '3', '--seconds', '0.2'], "
            f"spec_path={SPEC!r}, dirs={DIRS!r}, require_card=False)")
    names = _top_level(body)
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)
    assert "medical_image_generation_tpu_torch" in names


def test_a_metric_that_loads_jax_leaves_no_result(tmp_path, monkeypatch):
    """The look in ``sys.modules`` comes after the per-layer metrics of a
    ``--trace 1`` run have loaded: a metric file that loads a JAX module
    leaves the run with no result line."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "loads_flax.train.py").write_text(
        "import sys\nimport types\n\nsys.modules['flax'] = types.ModuleType('flax')\n\n\n"
        "def read(r):\n    return 1.0\n")
    spec = harness.load_json(SPEC)
    spec["per_layer"] = [{"name": "loads_flax.train", "unit": "%", "better": "lower",
                          "source": "device_trace", "layer": "device",
                          "moves": "train_step_ms"}]
    for c in spec["configs"]:
        c["file"] = os.path.join(DATA, c["file"])
    spec_path = tmp_path / "BENCHMARK.json"
    spec_path.write_text(json.dumps(spec))
    trace = {"busy_s": 1.0, "window_s": 1.0, "device_ops": [], "idle_gaps": []}
    fake = {"attempted": 1, "failed": 0, "memory_peak_bytes": 0, "metrics": {}, "checks": {},
            "layer": {"power": "none", "trace": trace}}
    load = harness.load_module

    def planted(path, tag):
        mod = load(path, tag)
        if tag == "driver":
            mod.run = lambda cell: fake
        return mod

    monkeypatch.setattr(harness, "load_module", planted)
    out = io.StringIO()
    try:
        rc = harness.main(["--workload", "tiny3d_train", "--seed", "3", "--seconds", "0.2",
                           "--trace", "1"], spec_path=str(spec_path),
                          dirs=[str(tmp_path)] + DIRS, require_card=False, out=out)
    finally:
        sys.modules.pop("flax", None)
    assert rc == 4 and out.getvalue() == ""


def test_reference_loads_nothing_of_the_program():
    body = ("from benchmark.reference import nets, augment, ldm\n"
            "from benchmark import rooflines, traffic")
    names = _top_level(body)
    assert not names & (set(harness.FORBIDDEN) | {"medical_image_generation_tpu_torch"})


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    """The whole run with the timed path broken underneath: correct is
    false."""
    load = harness.load_module

    def broken(path, tag):
        mod = load(path, tag)
        if tag == "driver":
            run = mod.run
            mod.run = lambda cell: run(cell, fault=faults.FAULTS[fault])
        return mod

    monkeypatch.setattr(harness, "load_module", broken)
    rc, line = tiny_run(seed=5)
    assert rc == 0 and line["correct"] is False, line["checks"]
