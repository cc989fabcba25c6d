"""The benchmark's run: find the cell's files by name, check the card, hand
the cell to its driver, read the per-layer metrics, and print the result.

Everything that belongs to one cell, configuration or metric is a file found
by its name under the benchmark's directories:

* ``workloads/<cell>.json``: the traffic and sizes of one cell, with its
  driver's name and the limits of its output check;
* ``configs/<config>.json`` (the file ``BENCHMARK.json`` names): the
  configuration as it is run;
* ``drivers/<kind>.py``: ``run(cell) -> dict`` for one entry point;
* ``metrics/<metric>.py``: ``read(r) -> float | None`` for one per-layer
  metric, from the traced window;
* ``kernels/<family>.json``: kernel name patterns of one family.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "medical_image_generation_tpu")


class NoCard(RuntimeError):
    pass


def find(dirs, sub: str, name: str, ext: str) -> str:
    for d in dirs:
        path = os.path.join(d, sub, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {sub}/{name}{ext} under {dirs}")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{tag}_" + os.path.basename(path)[:-3].replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(chips: int, require: bool = True):
    """The device of the run: the card, or a refusal; ``require=False``
    (tests) runs on the CPU."""
    import torch

    if not require:
        return torch.device("cpu"), {"platform": "cpu", "kind": "cpu", "count": 0}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA device(s); found "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return torch.device("cuda", 0), {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": chips}


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def leaf_gaps(prog, ref, keep=None):
    """|prog - ref| of each entry ``keep`` selects, against max(|ref|, the
    median |ref|)."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(abs(ref[i]) for i in idx)
    return [abs(prog[i] - ref[i]) / max(abs(ref[i]), med) for i in idx]


def gaps(prog, ref, keep=None):
    """The largest of ``leaf_gaps``."""
    return max(leaf_gaps(prog, ref, keep))


def load_cell(spec, spec_path, dirs, name, seed, seconds, trace, require_card=True,
              t_start=None):
    """(cell, driver module, device record) of the cell ``name``; raises
    ``NoCard`` without the devices it needs."""
    entry = {w["name"]: w for w in spec["workloads"]}[name]
    work = load_json(find(dirs, "workloads", name, ".json"))
    conf = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    cfg_file = load_json(os.path.join(os.path.dirname(os.path.abspath(spec_path)), conf["file"]))
    device, dev_info = card(entry["chips"], require_card)
    driver = load_module(find(dirs, "drivers", work["driver"], ".py"), "driver")
    kernels = {}
    for d in reversed(dirs):
        kd = os.path.join(d, "kernels")
        if os.path.isdir(kd):
            for f in sorted(os.listdir(kd)):
                if f.endswith(".json"):
                    kernels[f[:-5]] = load_json(os.path.join(kd, f))["patterns"]
    cell = SimpleNamespace(name=name, seed=seed, seconds=seconds, trace=trace, work=work,
                           cfg=cfg_file["config"], device=device,
                           t_start=time.perf_counter() if t_start is None else t_start,
                           kernels=kernels)
    return cell, driver, dev_info


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, spec_path=None, dirs=None, require_card=True, out=sys.stdout, t_start=None):
    """One run of one cell; prints the result line to ``out``. Returns the
    exit code."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    spec_path = spec_path or os.path.join(ROOT, "BENCHMARK.json")
    dirs = dirs or [BENCH_DIR]
    spec = load_json(spec_path)
    if args.workload not in {w["name"] for w in spec["workloads"]}:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    try:
        cell, driver, dev_info = load_cell(spec, spec_path, dirs, args.workload, args.seed,
                                           args.seconds, bool(args.trace), require_card,
                                           t_start)
    except NoCard as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    res = driver.run(cell)

    metrics = {}
    if args.trace:
        r = SimpleNamespace(**res["layer"], kernels=cell.kernels)
        for m in spec["per_layer"]:
            if "workloads" in m and args.workload not in m["workloads"]:
                continue
            v = load_module(find(dirs, "metrics", m["name"], ".py"), "metric").read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        print(f"card {res['layer']['power']}", file=sys.stderr)
    else:
        for m in spec["end_to_end"]:
            if m["name"] in res["metrics"]:
                metrics[m["name"]] = {"value": res["metrics"][m["name"]], "unit": m["unit"]}
    checks = {k: c for k, c in res["checks"].items() if c["limit"] is not None}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and res["failed"] == 0
    dev_info = dict(dev_info, memory_peak_bytes=res["memory_peak_bytes"])
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev_info}
    if args.trace:
        t = res["layer"]["trace"]
        line["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = checks
    found = forbidden_modules()  # after every module of the run, the metrics' too
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 4
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line, allow_nan=False), file=out)
    return 0
