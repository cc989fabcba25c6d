"""Tracing and step timing.

The port's counterpart of ``medical_image_generation_tpu/utils/
profiling.py`` (:1-88): ``StepTimer`` (per-step wall-clock p50 / p95 and
steps/s), ``maybe_progress`` (a tqdm bar when ``-p`` is given and tqdm is
installed, else the bare iterable), and ``profile_trace``, which records a
``torch.profiler`` trace of the enclosed block (host and CUDA activity) as
a Chrome trace into ``profile_dir`` when one is set (config ``profile_dir``
or the ``MEDIMGEN_PROFILE_DIR`` environment variable).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Record a torch.profiler trace of the enclosed block when enabled."""
    trace_dir = trace_dir or os.environ.get("MEDIMGEN_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}")


class StepTimer:
    """Per-step wall-clock stats: call tick() once per step."""

    def __init__(self, name: str = "step"):
        self.name = name
        self._times = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def summary(self, skip_first: int = 1) -> dict:
        times = np.asarray(self._times[skip_first:] or self._times)
        if times.size == 0:
            return {}
        return {
            "steps": int(times.size),
            "mean_s": float(times.mean()),
            "p50_s": float(np.percentile(times, 50)),
            "p95_s": float(np.percentile(times, 95)),
            "steps_per_sec": float(1.0 / times.mean()),
        }

    def report(self, skip_first: int = 1) -> str:
        s = self.summary(skip_first)
        if not s:
            return f"[{self.name}] no steps recorded"
        return (
            f"[{self.name}] {s['steps']} steps | {s['steps_per_sec']:.2f} steps/s | "
            f"p50 {s['p50_s'] * 1e3:.1f} ms | p95 {s['p95_s'] * 1e3:.1f} ms"
        )


def maybe_progress(iterable, enabled: bool, total: Optional[int] = None,
                   desc: str = ""):
    """tqdm progress bar gated by the -p flag (reference
    train_autoencoder.py:336,340); falls back to the bare iterable."""
    if not enabled:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, total=total, ncols=100, desc=desc)
