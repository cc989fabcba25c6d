"""Readings that the limits of a cell's output check are set from, in one
process on the card: the program's numbers on many seeds (checked steps and
one window step each), the control's (the plain reference computed in float8
in the program's place) and each planted fault's on a few seeds.

    python3 benchmark/calibrate.py --workload <cell> --first-seed <n> \
        --seeds 16 --control 3 --fault half_batch:12 --fault unchanged:1 [--out <file.jsonl>]

Prints one JSON line a reading. The benchmark's runs do not run this.
"""

import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from benchmark import faults, harness, loop  # noqa: E402


def worst(prog, ref, names, top=3):
    """The leaves of the largest gaps of each per-leaf number: [name, gap,
    program, reference]."""
    out = {}
    for key in ("grad", "change"):
        vals = [v for v in ref[key] if v is not None]
        med = sorted(abs(v) for v in vals)[len(vals) // 2]
        gs = [-1.0 if r is None else abs(p - r) / max(abs(r), med)
              for p, r in zip(prog[key], ref[key])]
        order = sorted(range(len(gs)), key=gs.__getitem__, reverse=True)[:top]
        out[key] = [[names[i], gs[i], prog[key][i], ref[key][i]] for i in order]
    return out


def quantiles(gaps):
    """The median, 90th percentile and largest of per-leaf gaps."""
    g = sorted(gaps)
    return [g[len(g) // 2], g[int(0.9 * (len(g) - 1))], g[-1]]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", action="append", default=[], help="name:count")
    p.add_argument("--also", type=int, nargs="*", default=[], help="more program seeds")
    p.add_argument("--dtype", help="the program's compute dtype instead of the cell's")
    p.add_argument("--out")
    a = p.parse_args(argv)
    spec_path = os.path.join(harness.ROOT, "BENCHMARK.json")
    spec = harness.load_json(spec_path)
    sink = open(a.out, "a") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def cell_of(seed):
        cell, driver, _ = harness.load_cell(spec, spec_path, [harness.BENCH_DIR], a.workload,
                                            seed, 0.0, False)
        if a.dtype:
            cell.work["compute_dtype"] = a.dtype
        return cell, driver

    plan = [("program", a.first_seed + i) for i in range(a.seeds)]
    plan += [("program", s) for s in a.also]
    plan += [("control", a.first_seed + 1000 + i) for i in range(a.control)]
    for f in a.fault:
        name, n = f.split(":")
        plan += [(f"fault:{name}", a.first_seed + 2000 + i) for i in range(int(n))]
    for kind, seed in plan:
        t0 = time.perf_counter()
        cell, driver = cell_of(seed)
        if kind == "control":
            checks, low, ref = loop.control(cell, driver.DRIVER)
            r = {"program": low, "reference": ref}
            rec = {}
        else:
            fault = faults.FAULTS[kind.split(":")[1]] if kind.startswith("fault:") else None
            res = driver.run(cell, fault=fault)
            checks = res["checks"]
            r = res["readings"]
            rec = {"scale": r["reference"].get("scale"), "step_ms": res["metrics"]["train_step_ms"]}
            del res
        on = [c is not None for c in r["reference"]["change"]]
        scaled = loop.scaled_gaps(r["program"]["grad"], r["reference"]["grad"], on)
        names = r["program"]["names"]
        top = sorted(scaled, key=scaled.__getitem__, reverse=True)[:8]
        rec.update({"quantiles": {k: quantiles(harness.leaf_gaps(r["program"][k],
                                                                 r["reference"][k], on))
                                  for k in ("grad", "change")},
                    "worst": worst(r["program"], r["reference"], r["program"]["names"]),
                    "scaled": [float(f"{g:.4g}") for g in scaled.values()],
                    "scaled_top": [[names[i], scaled[i]] for i in top],
                    "norms": [r["program"]["grad_norm"], r["reference"]["grad_norm"]],
                    "losses": [r["program"]["losses"], r["reference"]["losses"]]})
        del r
        gc.collect()
        torch.cuda.empty_cache()
        emit({"workload": a.workload, "kind": kind, "seed": seed,
              "dtype": cell.work["compute_dtype"],
              **{k: v["value"] for k, v in checks.items()}, **rec,
              "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
