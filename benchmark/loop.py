"""The run every training driver shares: set-up (the driver's trainer and
pools, then its checked steps and their readings), the window of steps back
to back, the profiled steps with ``--trace 1``, then, with the program's
state freed, the plain reference and the output check.

A driver module gives ``pools(cell) -> (host batches, draws)``,
``build(cell, host) -> trainer``, ``step_fn(trainer, host, draws, rows=None)
-> step``, ``readings(trainer, step, cell) -> dict``, ``reference(cell,
host, draws, mode=None) -> dict`` and ``flop_count(cell) -> dict``; a fault
``fault(driver, trainer, host, draws) -> step`` replaces the step (tests and
the calibration).
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from benchmark import harness, rooflines, trace

GIB = 2 ** 30
GRAD_Q = 0.75  # the quantile of the leaves that grad_gap reads


def first_grad_sq(opt, b2: float) -> list:
    """Each leaf's squared first gradient as an Adam received it, from its
    second moment after one step (nu = (1 - b2) g^2), held on the host."""
    return [(n / (1 - b2)).cpu() for n in opt.nu]


def kept(grad0):
    """Entries whose first raw gradient in the reference is at least a
    thousandth of the median leaf's root mean square: the others (a key's
    bias under softmax) move under Adam by round-off alone, and are left out
    of the change."""
    rms = [float(torch.linalg.vector_norm(g)) / g.numel() ** 0.5 for g in grad0]
    floor = 1e-3 * statistics.median(rms)
    return [g.abs() >= floor for g in grad0]


@torch.no_grad()
def norms(tensors, keep, square=False) -> list:
    """Each leaf's norm over its kept entries (of a squared tensor's
    entries with ``square``); None for a leaf with none kept."""
    out = []
    for t, k in zip(tensors, keep):
        v = t.to(k.device)[k].float()
        n = v.sum().sqrt() if square else torch.linalg.vector_norm(v)
        out.append(float(n) if bool(k.any()) else None)
    return out


def compare(prog, ref, limits):
    """The gaps, each with its limit (None: read, not compared), over the
    entries the reference keeps: each step's loss (the largest gap); the
    first gradient's global norm before the clip (``norm_gap``); each leaf's
    first gradient as the optimizer received it, the program's from its Adam
    state, the reference's clipped (``grad_gap``: the leaf at the
    ``GRAD_Q`` quantile; ``temb_grad_gap``: the median of the leaves on the
    timestep's path, where the rows of a batch differ most); each leaf's
    change after the checked steps (the largest gap). Sets each side's
    ``grad`` and ``change``."""
    if prog["names"] != ref["names"]:
        raise RuntimeError("the program's parameters differ from the reference's")
    grad0 = ref.pop("grad0")
    keep = kept(grad0)
    ref["grad"] = [None if n is None else n * ref["grad_scale"] for n in norms(grad0, keep)]
    del grad0
    prog["grad"] = norms(prog.pop("grad_sq"), keep, square=True)
    for side in (prog, ref):
        side.pop("grad0", None)
        side["change"] = norms(side.pop("delta"), keep)
    on = [c is not None for c in ref["change"]]
    scaled = scaled_gaps(prog["grad"], ref["grad"], on)
    vals = {"loss_gap": harness.gaps(prog["losses"], ref["losses"]),
            "norm_gap": harness.gaps([prog["grad_norm"]], [ref["grad_norm"]]),
            "grad_gap": leaf_quantile(scaled.values(), GRAD_Q),
            "temb_grad_gap": leaf_quantile([g for i, g in scaled.items() if ref["timestep"][i]],
                                           0.5),
            "change_gap": harness.gaps(prog["change"], ref["change"], on)}
    return {k: {"value": v, "limit": limits.get(k)} for k, v in vals.items()}


def leaf_quantile(gaps, q: float) -> float:
    """The leaf at the ``q`` quantile of ``gaps`` (the nearest rank below)."""
    g = sorted(gaps)
    return g[int(q * (len(g) - 1))]


def scaled_gaps(prog, ref, on) -> dict:
    """{leaf: its gap of the first gradient} over the leaves ``on`` selects,
    with the common factor of the two sides (the clip's: the median over the
    leaves of prog / ref) taken out. A few large leaves set the global norm,
    so one leaf's rounding moves the clip and with it every leaf; the clip is
    a scalar applied alike to every leaf, and ``norm_gap`` reads the norm it
    is taken from. All 1 when the program's gradient is nought."""
    idx = [i for i in range(len(ref)) if on[i]]
    c = statistics.median(prog[i] / ref[i] for i in idx if ref[i] > 0)
    if c <= 0:
        return dict.fromkeys(idx, 1.0)
    return dict(zip(idx, harness.leaf_gaps([p if p is None else p / c for p in prog], ref,
                                           on)))


def run(cell, driver, fault=None) -> dict:
    work, dev = cell.work, cell.device
    cuda = dev.type == "cuda"
    host, draws = driver.pools(cell)
    trainer = driver.build(cell, host)
    step = (fault or (lambda drv, *a: drv.step_fn(*a)))(driver, trainer, host, draws)
    prog = driver.readings(trainer, step, cell)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - cell.t_start
    k0 = work["checked_steps"]
    losses = []
    t0 = time.perf_counter()
    while True:
        losses.append(step(k0 + len(losses)))
        if time.perf_counter() - t0 >= cell.seconds:
            break
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n = len(losses)
    out = dict(attempted=n, failed=int((~torch.isfinite(torch.stack(losses))).sum()),
               memory_peak_bytes=peak,
               metrics={"setup_s": setup_s, "train_step_ms": wall / n * 1e3,
                        "peak_mem_gib": peak / GIB})
    if cell.trace:
        tr = trace.profile(lambda i: step(k0 + n + i), work["trace_steps"])
        trace.print_unmatched(tr, cell.kernels)
        count = driver.flop_count(cell)
        out["layer"] = dict(trace=tr, step_s=wall / n, flops=count["flops"],
                            calls={"flash": count["attention"], "groupnorm": count["groupnorm"]},
                            peak=rooflines.peaks(torch.cuda.get_device_name(0)),
                            power=harness.power_limit())
    del trainer, step, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = driver.reference(cell, host, draws)
    out["checks"] = compare(prog, ref, work["limits"])
    out["readings"] = dict(program=prog, reference=ref)
    return out


def control(cell, driver, mode="fp8"):
    """The reference under ``mode`` in the program's place, against the
    reference: (the control's numbers, its readings, the reference's)."""
    host, draws = driver.pools(cell)
    low = driver.reference(cell, host, draws, mode=mode)
    scale, grad0 = low.pop("grad_scale"), low.pop("grad0")
    low["grad_sq"] = [(g * scale) ** 2 for g in grad0]
    del grad0
    ref = driver.reference(cell, host, draws)
    return compare(low, ref, cell.work["limits"]), low, ref
