"""The metrics that read the program's spans and counter: a mean a profiled
step, None on an empty recorder, on a step count other than the trace's, and
from a program without the recorder."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from medical_image_generation_tpu_torch.utils import profiling

STREAM = {"augment_ms.train": "medimgen.augment", "latent_ms.train": "medimgen.latent",
          "unet_fwd_ms.train": "medimgen.unet_forward",
          "unet_bwd_ms.train": "medimgen.unet_backward",
          "optimizer_ms.train": "medimgen.optimizer"}
METRICS = [*STREAM, "host_syncs.train"]


class Event:
    """A stand-in for a CUDA timing event at ``ms`` on the stream."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def metric(name):
    return harness.load_module(harness.find([harness.BENCH_DIR], "metrics", name, ".py"),
                               "metric").read


def r_of(steps):
    return SimpleNamespace(trace={"steps": steps})


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def plant(rec, steps, syncs=30):
    """``steps`` train steps: the k-th span of STREAM holds the stream k + 1 ms,
    the step 20 ms; ``syncs`` host syncs a step."""
    for i in range(steps):
        t = 100.0 * i
        for k, span in enumerate(STREAM.values()):
            rec.spans.append(profiling.SpanRecord(span, "medimgen.train_step", i, i + 0.1,
                                                  (Event(t), Event(t + k + 1))))
        rec.spans.append(profiling.SpanRecord("medimgen.train_step", None, i, i + 0.2,
                                              (Event(t), Event(t + 20))))
        rec.counters["host_syncs"] = rec.counters.get("host_syncs", 0) + syncs


@pytest.mark.parametrize("name", METRICS)
def test_empty_recorder_reads_none(name, recorder):
    assert metric(name)(r_of(6)) is None


@pytest.mark.parametrize("name", METRICS)
def test_other_step_count_reads_none(name, recorder):
    plant(recorder, 5)
    assert metric(name)(r_of(6)) is None


@pytest.mark.parametrize("name", METRICS)
def test_planted_steps_read_their_mean(name, recorder):
    plant(recorder, 6)
    want = 30.0 if name == "host_syncs.train" else 1.0 + list(STREAM).index(name)
    assert metric(name)(r_of(6)) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_program_without_the_recorder_reads_none(name, monkeypatch):
    monkeypatch.delattr(profiling, "read")
    assert metric(name)(r_of(6)) is None


@pytest.mark.parametrize("name", list(STREAM))
def test_spans_without_stream_events_read_none(name, recorder):
    recorder.spans.extend(profiling.SpanRecord(s, None, 0.0, 1.0, None)
                          for s in ["medimgen.train_step", STREAM[name]])
    assert metric(name)(r_of(1)) is None
