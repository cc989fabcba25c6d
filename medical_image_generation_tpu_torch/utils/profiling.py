"""Tracing: phase spans and counters inside the program, and the operator's
profiler trace.

* ``span(name)``: a phase of the program, as a context manager. Each span
  enters a FUNCTION-scope record function (``_RecordFunctionFast``), so it
  sits in the profiler's host timeline on the clock the device kernels are
  stamped with, and names the host time it covers; being no user
  annotation, the profiler mirrors nothing of it onto the device timeline.
  On CUDA it also records an event on the current stream at entry and at
  exit: the span's stream time is the time the phase holds the stream,
  idle included, so consecutive phases add up to the stream's wall time.
* ``count(name, n)``: a counter; ``host_syncs()``: counts the block's
  host-blocking CUDA calls into the counter ``host_syncs``.
* ``read()``, ``records()`` and ``reset()``: what was recorded.

The recorder is on exactly while a ``torch.profiler`` (or autograd
profiler) is active; otherwise ``span`` returns one shared no-op context and
``count`` does nothing. It keeps the last ``MAX_SPANS`` spans and holds no
tensor.

``profile_trace`` records a ``torch.profiler`` trace of the enclosed block
(host and CUDA activity, the spans with it) as a Chrome trace into
``profile_dir`` when one is set (config ``profile_dir`` or the
``MEDIMGEN_PROFILE_DIR`` environment variable). ``maybe_progress`` is a
tqdm bar when ``-p`` is given and tqdm is installed, else the bare iterable.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
import warnings
from typing import Iterator, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

MAX_SPANS = 512
SYNC_WARNING = "called a synchronizing CUDA operation"  # torch's sync debug mode

_on = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]  # the innermost span open at entry
    start_s: float  # host clock (time.perf_counter)
    end_s: float
    events: Optional[tuple]  # (entry, exit) CUDA events on the span's stream; None off CUDA


class Recorder:
    """The spans (the last ``max_spans``) and counters of a process."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.spans = collections.deque(maxlen=max_spans)
        self.counters = {}
        self.open = []  # names of the spans entered and not yet left

    def reset(self) -> None:
        self.spans.clear()
        self.counters.clear()

    def read(self) -> dict:
        """{"spans": {name: {"n", "host_s", "stream_s"}}, "counters": {name:
        total}}; ``stream_s`` is None for spans without CUDA events. Waits
        for the last span's events."""
        out = {}
        for r in self.spans:
            s = out.setdefault(r.name, {"n": 0, "host_s": 0.0, "stream_s": None})
            s["n"] += 1
            s["host_s"] += r.end_s - r.start_s
            if r.events is not None:
                r.events[1].synchronize()
                s["stream_s"] = (s["stream_s"] or 0.0) + r.events[0].elapsed_time(
                    r.events[1]) / 1e3
        return {"spans": out, "counters": dict(self.counters)}


RECORDER = Recorder()


def _stream_event():
    """A timing event recorded on the current stream, or None before the
    process has used CUDA."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "rf", "ev0", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        opened = RECORDER.open
        self.parent = opened[-1] if opened else None
        opened.append(self.name)
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.ev0 = _stream_event()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        events = None if self.ev0 is None else (self.ev0, _stream_event())
        self.rf.__exit__(*exc)
        RECORDER.open.pop()
        RECORDER.spans.append(SpanRecord(self.name, self.parent, self.t0, t1, events))
        return False


def span(name: str):
    """A span named ``name`` around the block while the profiler is on."""
    return _Span(name) if _on() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the profiler is on."""
    if _on():
        RECORDER.counters[name] = RECORDER.counters.get(name, 0) + n


class _SyncCount:
    """Sets torch's sync debug mode to "warn" around the block (on CUDA),
    counts the warnings it raises into ``host_syncs`` and passes every other
    warning on; the previous mode comes back on exit."""

    __slots__ = ("caught", "log", "mode")

    def __enter__(self):
        self.caught = warnings.catch_warnings(record=True)
        self.log = self.caught.__enter__()
        warnings.simplefilter("always")
        self.mode = None
        if torch.cuda.is_initialized():
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        try:
            if self.mode is not None:
                torch.cuda.set_sync_debug_mode(self.mode)
        finally:
            self.caught.__exit__(*exc)
        syncs = 0
        for w in self.log:
            if SYNC_WARNING in str(w.message):
                syncs += 1
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno,
                                       source=w.source)
        count("host_syncs", syncs)
        return False


def host_syncs():
    """Count the block's host-blocking CUDA calls into ``host_syncs`` while
    the profiler is on: what torch's sync debug mode flags (blocking copies
    between host and card, reads of device values, stream synchronises; not
    a device-wide ``torch.cuda.synchronize()``). The counter reads 0 off
    CUDA."""
    return _SyncCount() if _on() else _OFF


def read() -> dict:
    return RECORDER.read()


def records() -> list:
    """The recorded spans, oldest exit first."""
    return list(RECORDER.spans)


def reset() -> None:
    RECORDER.reset()


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
