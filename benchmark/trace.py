"""Reading a profiled window of steps: device busy time, the window's length,
device time by kernel family, the longest device operations and the longest
idle gaps by what the host was doing.

Before the steps the profiler records ``WARM`` ``torch.cuda._sleep`` kernels
(``spin_kernel``, which no path of the program launches) and a synchronise,
so that a trace started cold drops none of the steps' first kernels; those
kernels are left out of what is read.
"""

from __future__ import annotations

import bisect
import sys
import time

import torch

WARM = 256
TOP = 10


def profile(step, steps: int) -> dict:
    """``step(i)`` for i < ``steps`` under the profiler, then a synchronise."""
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = prof.events()
    dev_type = torch.autograd.DeviceType.CUDA
    dev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == dev_type and "spin_kernel" not in e.name))
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type != dev_type)
    if not dev:
        raise RuntimeError("the profiler recorded no device operation in the window")
    return read(dev, host, window, steps)


def _merge(intervals):
    out = []
    for s, e, _ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t):
    """Name of the shortest host event that covers time ``t``."""
    best = None
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - 4000):i]):
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "(no host op)"


def read(dev, host, window_s: float, steps: int) -> dict:
    """dev, host: sorted (start us, end us, name); returns the trace's
    summary (seconds)."""
    merged = _merge(dev)
    busy = sum(e - s for s, e in merged) / 1e6
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:500]
    starts = [h[0] for h in host]
    by_host = {}
    for g, s, e in gaps:
        name = _innermost(host, starts, (s + e) / 2)
        by_host[name] = by_host.get(name, 0.0) + g / 1e6
    return dict(
        steps=steps, window_s=window_s, busy_s=busy, kernels=by_name,
        device_ops=[[n[:160], v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[n[:160], v] for n, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]])


def family_seconds(trace: dict, patterns) -> float:
    """Device seconds of the kernels whose name holds one of ``patterns``."""
    return sum(v for n, v in trace["kernels"].items() if any(p in n for p in patterns))


def print_unmatched(trace: dict, families: dict, top: int = 8) -> None:
    """The longest kernels that no family's patterns name, on standard error
    (seconds over the traced steps)."""
    pats = [p for ps in families.values() for p in ps]
    rest = sorted(((v, n) for n, v in trace["kernels"].items()
                   if not any(p in n for p in pats)), reverse=True)[:top]
    for v, n in rest:
        print(f"unmatched kernel {v:.6f} s {n[:140]}", file=sys.stderr)
