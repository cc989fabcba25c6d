"""PyTorch port, tracing: the phase spans and the ``host_syncs`` counter of
the diffusion train step (``utils/profiling.py``), on the profiler's clock
and only while a profiler runs. Tiny 2D configs on the CPU; the tests marked
``cuda`` run only with a card (``python3 -m pytest --noconftest -q
tests/test_torch_tracing.py`` there). Imports no JAX."""

import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from medical_image_generation_tpu_torch.planning import planner as tplanner
from medical_image_generation_tpu_torch.training import common
from medical_image_generation_tpu_torch.training.train_ddpm import DDPMTrainer
from medical_image_generation_tpu_torch.training.train_ldm import LDMTrainer
from medical_image_generation_tpu_torch.utils import profiling

PHASES = ["medimgen.augment", "medimgen.latent", "medimgen.unet_forward",
          "medimgen.unet_backward", "medimgen.optimizer"]
NAMES = {"medimgen.batch_to_device", "medimgen.train_step", *PHASES}
ATTN = "medimgen.attention"  # each attention block's forward, inside the U-Net forward


def n_attn(tr):
    from medical_image_generation_tpu_torch.models.blocks import AttentionBlock

    return sum(isinstance(m, AttentionBlock) for m in tr.unet.modules())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events and the sync debug mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _trainer(kind, device="cpu"):
    vae, ddpm, _ = tplanner.flagship_configs(tiny=True, spatial_dims=2)
    cfg = tplanner.create_config_dict(tplanner.flagship_dataset(True, 2), [0], 1, vae, ddpm)
    cfg["time_scheduler_params"] = dict(cfg["time_scheduler_params"], num_train_timesteps=50)
    if kind == "ddpm":
        return DDPMTrainer.from_config(cfg, device=device, dtype=torch.float32)
    gen = common.build_generator(cfg, "vae", torch.float32, device=device)
    tr = LDMTrainer.from_config(cfg, gen.state_dict(), device=device, dtype=torch.float32)
    tr.probe_latent(torch.rand(2, *tr.aug_cfg.crop_to, 1))
    return tr


def _step(tr, host_batch, draws=None):
    imgs, _ = common.batch_to_device(host_batch, tr.device)
    return tr.train_step(imgs, draws=draws)


def _batch(tr):
    return torch.rand(2, *tr.aug_cfg.crop_to, 1).numpy()


def test_recorder_is_off_without_the_profiler():
    tr = _trainer("ldm")
    _step(tr, _batch(tr))
    profiling.count("host_syncs", 3)
    assert profiling.records() == []
    assert profiling.read() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("kind", ["ldm", "ddpm"])
def test_train_step_phases_under_the_profiler(kind):
    tr = _trainer(kind)
    batch = _batch(tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(tr, batch)
    recs = sorted(profiling.records(), key=lambda r: r.start_s)
    attn = [r for r in recs if r.name == ATTN]
    recs = [r for r in recs if r.name != ATTN]
    assert [r.name for r in recs] == ["medimgen.batch_to_device", "medimgen.train_step",
                                      *PHASES]
    fwd = recs[2 + PHASES.index("medimgen.unet_forward")]
    assert len(attn) == n_attn(tr) > 0
    assert all(a.parent == "medimgen.unet_forward" and fwd.start_s <= a.start_s
               and a.end_s <= fwd.end_s for a in attn)
    root, step, phases = recs[0], recs[1], recs[2:]
    assert root.parent is None and step.parent is None
    assert root.end_s <= step.start_s
    assert all(p.parent == "medimgen.train_step" for p in phases)
    assert step.start_s <= phases[0].start_s and phases[-1].end_s <= step.end_s
    assert all(a.end_s <= b.start_s for a, b in zip(phases, phases[1:]))
    assert all(r.events is None for r in recs)  # no CUDA events on the CPU
    assert all(r.events is None for r in attn)
    out = profiling.read()
    assert {k: v["n"] for k, v in out["spans"].items()} == {**dict.fromkeys(NAMES, 1),
                                                            ATTN: len(attn)}
    assert all(v["stream_s"] is None and v["host_s"] > 0 for v in out["spans"].values())
    assert out["counters"] == {"host_syncs": 0}
    seen = {e.name: e for e in prof.events() if e.name.startswith("medimgen.")}
    assert set(seen) == NAMES | {ATTN}
    for e in seen.values():
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation


def test_recorder_keeps_the_last_spans_only(monkeypatch):
    tr = _trainer("ldm")
    batch = _batch(tr)
    per_step = len(NAMES) + n_attn(tr)
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder(max_spans=per_step))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            _step(tr, batch)
    recs = profiling.records()
    assert len(recs) == per_step
    assert {r.name for r in recs} == NAMES | {ATTN}  # the last step's
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.MAX_SPANS + 100):
            with profiling.span(f"medimgen.s{i}"):
                pass
    recs = profiling.records()
    assert len(recs) == profiling.MAX_SPANS
    assert recs[-1].name == f"medimgen.s{profiling.MAX_SPANS + 99}"


def test_reset_empties_the_recorder():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("medimgen.a"), profiling.span("medimgen.b"):
            profiling.count("c", 2)
    assert [(r.name, r.parent) for r in profiling.records()] == [
        ("medimgen.b", "medimgen.a"), ("medimgen.a", None)]
    assert profiling.read()["counters"] == {"c": 2}
    profiling.reset()
    assert profiling.records() == []
    assert profiling.read() == {"spans": {}, "counters": {}}


def test_host_syncs_passes_other_warnings_on():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.warns(UserWarning, match="left alone"):
            with profiling.host_syncs():
                warnings.warn("left alone")
    assert profiling.read()["counters"] == {"host_syncs": 0}


@pytest.mark.cuda
def test_no_span_reaches_the_device_timeline_on_gpu(cuda):
    tr = _trainer("ldm", cuda)
    batch = _batch(tr)
    _step(tr, batch)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _step(tr, batch)
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert dev and not any(n.startswith("medimgen.") for n in dev)
    spans = profiling.read()["spans"]
    assert set(spans) == NAMES | {ATTN}
    # the attention blocks lie inside the U-Net's forward on its stream
    assert 0 < spans[ATTN]["stream_s"] <= spans["medimgen.unet_forward"]["stream_s"]
    # children lie inside the step on one stream
    step = spans["medimgen.train_step"]["stream_s"]
    assert 0 < sum(spans[p]["stream_s"] for p in PHASES) <= step


@pytest.mark.cuda
def test_host_syncs_counts_a_planted_read_on_gpu(cuda):
    tr = _trainer("ldm", cuda)
    batch = _batch(tr)
    draws = tr.make_draws(torch.as_tensor(batch))

    def syncs():
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            _step(tr, batch, draws)
        return profiling.read()["counters"]["host_syncs"]

    syncs()  # warm
    base = syncs()
    assert base >= 1  # the timesteps' blocking copy
    forward = tr.unet.forward

    def planted(*a, **k):
        out = forward(*a, **k)
        float(out.float().mean())
        return out

    tr.unet.forward = planted
    assert syncs() == base + 1
    assert torch.cuda.get_sync_debug_mode() == 0  # restored
