"""PyTorch port: clip + AdamW as two kernel passes (``ops/adamw.py``,
``csrc/adamw.cu``).

On the CPU: the host tables the kernels read (the partition of a tensor list
into tiles and launches, the addresses, flags and None gradients), the fp32
scalars handed to the kernels, and that CPU tensors take the plain
``_foreach`` version and launch nothing. Marked ``cuda``: the kernels
against the plain version on the card. CUDA kernels have no CPU mode, so
those skip without a GPU; on one, run

    python -m pytest --noconftest tests/test_torch_adamw.py -q

This file imports no JAX, so it also runs where only PyTorch is installed.
The plain version is held against optax in ``tests/test_torch_train_ops.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from medical_image_generation_tpu_torch.ops import adamw as ta
from medical_image_generation_tpu_torch.training import common as tcommon
from medical_image_generation_tpu_torch.utils import profiling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels have no CPU mode)")
    return torch.device("cuda")


def _state(shapes, device, mu_dtype=torch.float32, seed=0):
    gen = np.random.default_rng(seed)
    params = [torch.from_numpy(gen.standard_normal(s).astype(np.float32)).to(device)
              for s in shapes]
    mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    return params, mu, nu


# ------------------------------------------------------------- host tables

@pytest.mark.parametrize("numels,max_tensors", [
    ([4096, 1, 0, 4097, 12288], ta.MAX_TENSORS),
    ([5] * 10, 4),
    ([ta.TILE * 3 + 1] * 7 + [0], 3),
    ([1], 1),
])
def test_partition_tiles_and_launches(numels, max_tensors):
    """Consecutive runs of at most max_tensors tensors covering the list once;
    each tensor owns ceil(numel / TILE) tiles from the launch's offset 0."""
    launches = ta.partition(numels, max_tensors)
    assert launches[0].lo == 0 and launches[-1].hi == len(numels)
    for a, b in zip(launches, launches[1:]):
        assert a.hi == b.lo
    for ln in launches:
        assert 0 < ln.hi - ln.lo <= max_tensors
        assert len(ln.tile_start) == ln.hi - ln.lo + 1 and ln.tile_start[0] == 0
        for j, i in enumerate(range(ln.lo, ln.hi)):
            assert ln.tile_start[j + 1] - ln.tile_start[j] == -(-numels[i] // ta.TILE)
    assert len(launches) == -(-len(numels) // max_tensors)


def test_table_fits_the_kernel_parameter_space():
    """A launch's table and scalars travel by value: they fit sm_90's 32 KB
    of kernel parameters, with room for the pointers and ints beside them; the
    3D U-Net's 276 tensors take one launch a pass."""
    args = ctypes.sizeof(ta.AdamwTable) + ctypes.sizeof(ta.AdamwHyper) + 4 * 8 + 2 * 4
    assert args <= ta.KERNEL_PARAM_BYTES
    assert ta.MAX_TENSORS >= 276 and len(ta.partition([8] * 276)) == 1
    assert len(ta.partition([8] * (ta.MAX_TENSORS + 1))) == 2


def test_plan_tables_hold_addresses_flags_and_none_gradients():
    """Addresses, sizes and tile offsets of each tensor in its launch's
    table; a None gradient is address 0; sharded and 16-byte flags."""
    shapes = [(3, 5), (8,), (4, 4, 2), (7,)]
    params, mu, nu = _state(shapes, "cpu", torch.bfloat16)
    plan = ta.Plan(params, mu, nu, sharded=[True, False, True, False], sms=2)
    grads = [torch.ones_like(p) for p in params]
    grads[2] = None
    plan.set_grads(grads)
    assert plan.grid_max == 2 * ta.BLOCKS_PER_SM
    t = plan.tables[0]
    assert len(plan.tables) == 1 and t.n == 4
    assert list(t.tile_start[:5]) == [0, 1, 2, 3, 4]
    for i, p in enumerate(params):
        assert t.p[i] == p.data_ptr() and t.mu[i] == mu[i].data_ptr()
        assert t.nu[i] == nu[i].data_ptr() and t.numel[i] == p.numel()
        assert t.g[i] == (0 if grads[i] is None else grads[i].data_ptr())
        aligned = all(x.data_ptr() % 16 == 0 for x in (p, nu[i]) + (
            () if grads[i] is None else (grads[i],))) and mu[i].data_ptr() % 8 == 0
        assert t.flags[i] == (ta.SHARDED if i in (0, 2) else 0) | (ta.VEC if aligned else 0)
    # the next step's gradients replace the addresses
    grads2 = [torch.ones_like(p) for p in params]
    plan.set_grads(grads2)
    assert [t.g[i] for i in range(4)] == [g.data_ptr() for g in grads2]


def test_plan_splits_long_lists_and_sizes_each_launchs_grid():
    """Past MAX_TENSORS the list takes a second table, which starts at the
    next tensor; a launch's grid is its tile count up to BLOCKS_PER_SM a
    SM."""
    params, mu, nu = _state([(3,)] * (ta.MAX_TENSORS + 5), "cpu")
    plan = ta.Plan(params, mu, nu, sms=2)
    plan.set_grads([None] * len(params))
    assert [t.n for t in plan.tables] == [ta.MAX_TENSORS, 5]
    assert plan.tables[1].p[0] == params[ta.MAX_TENSORS].data_ptr()
    assert list(plan.tables[1].tile_start[:6]) == [0, 1, 2, 3, 4, 5]
    assert plan.grids == [2 * ta.BLOCKS_PER_SM, 5]


def test_plan_takes_misaligned_tensors_off_the_16_byte_path():
    """A view at an odd element offset keeps its tensor on the element
    path; so does a gradient at one."""
    base = torch.zeros(40)
    p, m, v = base[1:9], torch.zeros(8), torch.zeros(8)
    q, mq, vq = torch.zeros(8), torch.zeros(8), torch.zeros(8)
    plan = ta.Plan([p, q], [m, mq], [v, vq], sms=1)
    assert plan.base_flags == [0, ta.VEC]
    g_off = torch.zeros(12)[1:9]
    plan.set_grads([torch.zeros(8), g_off])
    assert list(plan.tables[0].flags[:2]) == [0, 0]
    plan.set_grads([torch.zeros(8), torch.zeros(8)])
    assert list(plan.tables[0].flags[:2]) == [0, ta.VEC]


def test_plan_takes_channels_last_layouts_and_refuses_others():
    """All four tensors of a param share its dense layout (a channels-last
    conv weight included) and the table takes the gradient itself; a
    gradient of another shape, or a list of another length, raises."""
    w = torch.zeros(4, 3, 2, 2, 2).contiguous(memory_format=torch.channels_last_3d)
    m, v = torch.zeros_like(w, dtype=torch.bfloat16), torch.zeros_like(w)
    plan = ta.Plan([w], [m], [v], sms=1)
    g = torch.zeros_like(w)
    assert plan.set_grads([g]) == [] and plan.tables[0].g[0] == g.data_ptr()
    # a 1x1x1 conv weight: the strides of its size-1 dims are free
    k = torch.zeros(6, 4, 1, 1, 1)
    kplan = ta.Plan([k], [torch.zeros_like(k)], [torch.zeros_like(k)], sms=1)
    kg = torch.zeros(24).as_strided((6, 4, 1, 1, 1), (4, 1, 4, 4, 4))  # as autograd gave one
    assert kg.stride() != k.stride()
    assert kplan.set_grads([kg]) == []
    assert kplan.tables[0].g[0] == kg.data_ptr()
    with pytest.raises(ValueError):
        plan.set_grads([torch.zeros(4, 3, 2, 2, 1)])
    with pytest.raises(ValueError):
        plan.set_grads([])
    with pytest.raises(TypeError):
        ta.Plan([w.double()], [m], [v.double()], sms=1)
    with pytest.raises(ValueError):
        ta.Plan([torch.zeros(6, 4)[:, :2]], [torch.zeros(6, 2)], [torch.zeros(6, 2)], sms=1)


@pytest.mark.parametrize("make", [
    lambda w: torch.randn(4, 3, 2, 2, 2),  # contiguous: other strides than w's
    lambda w: torch.randn_like(w).to(torch.bfloat16),
    lambda w: torch.randn(4, 2, 2, 2, 3).permute(0, 4, 1, 2, 3).transpose(2, 3),
])
def test_plan_copies_a_gradient_of_another_layout_or_dtype(make):
    """A gradient in another layout or dtype than its fp32 param's (as
    ``torch.autograd.grad`` may give one) is copied into the param's layout:
    the table holds the copy, which set_grads returns, with the gradient's
    values, and ``adamw_update.grad_copies`` counts it."""
    w = torch.zeros(4, 3, 2, 2, 2).contiguous(memory_format=torch.channels_last_3d)
    plan = ta.Plan([w], [torch.zeros_like(w)], [torch.zeros_like(w)], sms=1)
    g = make(w)
    before = ta.adamw_update.grad_copies
    copies = plan.set_grads([g])
    assert ta.adamw_update.grad_copies - before == 1 and len(copies) == 1
    c = copies[0]
    assert c.dtype == torch.float32 and c.stride() == w.stride()
    assert plan.tables[0].g[0] == c.data_ptr()
    assert torch.equal(c, g.float())


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_hyper_scalars_round_as_torch_rounds_an_fp32_operand(mu_dtype):
    """The kernel's fp32 scalars equal what PyTorch's ops make of the plain
    version's Python floats: b1 rounded to mu's dtype, 1 - b1 and 1 - b2
    rounded once from double, the bias corrections' reciprocals taken in
    double (a ``_foreach_div`` by a scalar on CUDA)."""
    opt = tcommon.AdamW([torch.zeros(3)], lambda s: 2e-5, 1.0, 1e-2, mu_dtype=mu_dtype)
    h = opt._hyper()
    c = h.to_c(1.0)
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    assert c.b1_mu == torch.tensor(0.9, dtype=mu_dtype).item()
    assert c.one_minus_b1 == f32(1 - 0.9) and c.one_minus_b2 == f32(1 - 0.999)
    assert c.b2 == f32(0.999) and c.eps == f32(1e-8) and c.wd == f32(1e-2)
    assert c.neg_lr == -f32(2e-5) and c.inv_bc1 == f32(1 / h.bc1) and c.inv_bc2 == f32(1 / h.bc2)
    assert h.bc1 == f32(1 - f32(0.9)) and h.bc2 == f32(1 - f32(0.999))
    assert (c.clip, c.has_wd, c.max_norm) == (1, 1, 1.0)
    assert (h.to_c(None).clip, h._replace(wd=0.0).to_c(1.0).has_wd) == (0, 0)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_path_and_launch_nothing(mu_dtype):
    """AdamW on CPU tensors: no plan, no launch, no kernel counter; the
    result is the plain clip and ``adamw_plain_`` step for step."""
    shapes = [(5, 7), (11,), (3, 3, 4)]
    params, _, _ = _state(shapes, "cpu")
    ref = [p.clone() for p in params]
    opt = tcommon.AdamW(params, lambda s: 2e-3, 1.0, 1e-2, mu_dtype=mu_dtype)
    rmu = [torch.zeros_like(p, dtype=mu_dtype) for p in ref]
    rnu = [torch.zeros_like(p) for p in ref]
    launches = (ta.sq_norm.launches, ta.adamw_update.launches)
    gen = np.random.default_rng(1)
    profiling.RECORDER.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(4):
            gs = [torch.from_numpy(gen.standard_normal(s).astype(np.float32))
                  * (0.05 if i % 2 else 3.0) for s in shapes]
            opt.step([g.clone() for g in gs])
            ta.clip_by_global_norm(gs, 1.0)
            ta.adamw_plain_(ref, gs, rmu, rnu, ta.Hyper(2e-3, 0.9, 0.999, 1e-8, 1e-2, float(
                torch.tensor(0.9, dtype=mu_dtype)), *(float(np.float32(1) - np.float32(b) ** (
                    np.float32(i + 1))) for b in (0.9, 0.999))))
            for a, b in zip(params + opt.mu + opt.nu, ref + rmu + rnu):
                assert torch.equal(a, b)
    assert opt._plan is None and opt.last_norm.device.type == "cpu"
    assert (ta.sq_norm.launches, ta.adamw_update.launches) == launches
    assert "adamw_kernel_steps" not in profiling.RECORDER.counters


# ------------------------------------------------------------------ on GPU

# shapes: a channels-last conv weight, a size that is no multiple of 4, a
# multi-tile tensor with a ragged last tile, a bias; index 3 gets no gradient
GPU_SHAPES = [(8, 4, 3, 3, 3), (1001,), (3 * ta.TILE + 36,), (16,), (5, 6)]


def _gpu_state(dev, mu_dtype, seed=0):
    params, mu, nu = _state(GPU_SHAPES, dev, mu_dtype, seed)
    params[0] = params[0].contiguous(memory_format=torch.channels_last_3d)
    mu[0] = torch.zeros_like(params[0], dtype=mu_dtype)
    nu[0] = torch.zeros_like(params[0])
    return params, mu, nu


def _grads(params, step, clipped=None):
    """Seeded gradients of the step: a norm of ~350 (clipped) on even steps,
    ~0.5 (unclipped) on odd ones, unless ``clipped`` says."""
    gen = torch.Generator(device=params[0].device).manual_seed(step)
    scale = 3.0 if (step % 2 == 0 if clipped is None else clipped) else 0.004
    gs = [torch.randn(p.shape, generator=gen, device=p.device) * scale for p in params]
    gs = [g.contiguous(memory_format=torch.channels_last_3d) if g.dim() == 5 else g for g in gs]
    gs[3] = None
    return gs


def _plain_step(params, mu, nu, grads, norm, h):
    """The plain version's step with the clip taken by ``norm``."""
    gs = [torch.zeros_like(p) if g is None else g.clone() for g, p in zip(grads, params)]
    ta.clip_by_global_norm(gs, 1.0, norm=norm)
    ta.adamw_plain_(params, gs, mu, nu, h)


def _assert_close(got, ref, rtol):
    for i, (a, b) in enumerate(zip(got, ref)):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=0,
                                   msg=lambda m: f"tensor {i}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype,wd", [(torch.bfloat16, 1e-2), (torch.float32, 1e-2),
                                         (torch.bfloat16, 0.0), (torch.float32, 0.0)])
def test_kernels_match_plain_over_five_steps_on_gpu(cuda, mu_dtype, wd):
    """Five steps, clipped and unclipped alternating. The norm differs from
    the plain one by its summation order (rtol 1e-5); driven by the
    kernels' norm, the plain step gives the same params, mu and nu (rtol
    1e-6). At most 4 launches a step (the scratch's zero fill, sq_norm,
    adamw_update), no per-parameter temporary, the norm a 0-d device
    tensor, and ``adamw_kernel_steps`` counts the steps."""
    from torch.profiler import ProfilerActivity, profile

    params, mu, nu = _gpu_state(cuda, mu_dtype)
    rp, rmu, rnu = [p.clone() for p in params], [m.clone() for m in mu], [v.clone() for v in nu]
    opt = tcommon.AdamW(params, lambda s: 2e-3 * (1 + s), 1.0, wd, mu_dtype=mu_dtype)
    ref = tcommon.AdamW(rp, lambda s: 2e-3 * (1 + s), 1.0, wd, mu_dtype=mu_dtype)
    profiling.RECORDER.reset()
    for step in range(5):
        grads = _grads(params, step)
        before = (ta.sq_norm.launches, ta.adamw_update.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            opt.step(grads)
            torch.cuda.synchronize()
        device_ops = [e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(device_ops) <= 4, device_ops
        # sq_norm's ~4 KB of scratch and the norm's 512-byte block; no
        # per-parameter temporary (the largest tensor here is 48 KB)
        assert torch.cuda.max_memory_allocated() - held <= 8192
        assert torch.cuda.memory_allocated() - held <= 512  # the scratch is freed
        assert (ta.sq_norm.launches - before[0], ta.adamw_update.launches - before[1]) == (1, 1)
        norm = opt.last_norm
        assert norm.dim() == 0 and norm.is_cuda and norm.dtype == torch.float32
        plain_norm = ta.global_norm([torch.zeros_like(p) if g is None else g
                                     for g, p in zip(grads, params)])
        torch.testing.assert_close(norm, plain_norm, rtol=1e-5, atol=0)
        _plain_step(rp, rmu, rnu, grads, norm, ref._hyper())
        _assert_close(params + opt.mu + opt.nu, rp + rmu + rnu, 1e-6)
        assert (float(norm) > 1.0) == (step % 2 == 0)
    assert profiling.RECORDER.counters.get("adamw_kernel_steps") == 5
    assert opt.count == 5


@pytest.mark.cuda
def test_sharded_and_replicated_sums_on_gpu(cuda):
    """sq_norm's two sums are the sharded and the replicated tensors' sums of
    squares; the norm of a step under a trivial axis is sqrt of both."""
    params, mu, nu = _gpu_state(cuda, torch.bfloat16)
    sharded = [True, False, True, True, False]
    plan = ta.Plan(params, mu, nu, sharded)
    grads = _grads(params, 0)
    plan.set_grads(grads)
    sums = ta.sq_norm(plan).clone()
    sq = [0.0 if g is None else float(g.double().square().sum()) for g in grads]
    want = [sum(s for s, f in zip(sq, sharded) if f), sum(s for s, f in zip(sq, sharded) if not f)]
    torch.testing.assert_close(sums.double().cpu(), torch.tensor(want, dtype=torch.float64),
                               rtol=1e-5, atol=0)
    opt = tcommon.AdamW(params, lambda s: 1e-3, 1.0, 1e-2, mu_dtype=torch.bfloat16,
                        sharded=sharded)
    opt.step(grads)
    torch.testing.assert_close(opt.last_norm.double().cpu(),
                               torch.tensor(sum(want), dtype=torch.float64).sqrt(),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_sharded_sum_all_reduced_over_a_model_axis_of_two_on_gpu(cuda, tmp_path):
    """Two ranks (gloo, both on the card) take one clipped step with the
    Megatron layout's norm: the sharded tensors' sum of squares is summed
    over the axis between the two kernels, the replicated ones counted
    once. Each rank gets the whole gradient's norm, and its params are the
    plain step's driven by that norm."""
    from torch_dist_ranks import Ranks, adamw_sharded_step

    shapes, sharded = [(64, 5), (33,), (4100,), (7,)], [True, False, True, False]
    gen = torch.Generator().manual_seed(11)

    def draw(shape, scale):
        return torch.randn(shape, generator=gen) * scale

    rep_p = [draw(s, 1.0) for s in shapes]
    rep_g = [draw(s, 0.5) for s in shapes]
    params, grads = [], []
    for _ in range(2):  # each rank's own shards, the replicated tensors alike
        params.append([draw(s, 1.0) if sh else p for s, sh, p in zip(shapes, sharded, rep_p)])
        grads.append([draw(s, 0.5) if sh else g for s, sh, g in zip(shapes, sharded, rep_g)])
    out = Ranks(adamw_sharded_step, 2, tmp_path, params, grads, sharded).join()
    want = sum(float((g.double() ** 2).sum()) for r in range(2)
               for g, sh in zip(grads[r], sharded) if sh)
    want = (want + sum(float((g.double() ** 2).sum()) for g, sh in zip(rep_g, sharded)
                       if not sh)) ** 0.5
    assert want > 1.0  # clipped
    for r, (norm, got) in enumerate(out):
        assert norm == pytest.approx(want, rel=1e-5)
        rp = [p.to(cuda) for p in params[r]]
        ref = tcommon.AdamW(rp, lambda s: 1e-3, 1.0, 1e-2, mu_dtype=torch.bfloat16)
        _plain_step(rp, ref.mu, ref.nu, [g.to(cuda) for g in grads[r]],
                    torch.tensor(norm, device=cuda), ref._hyper())
        _assert_close([p.to(cuda) for p in got], rp, 1e-6)


@pytest.mark.cuda
def test_a_list_past_one_table_takes_two_launches_a_pass_on_gpu(cuda):
    """MAX_TENSORS + 6 tensors: two launches of each kernel, the second
    sq_norm adding to the first's sums; the result as the plain step's."""
    shapes = [(37,)] * (ta.MAX_TENSORS + 6)
    params, mu, nu = _state(shapes, cuda, torch.bfloat16)
    rp, rmu, rnu = [p.clone() for p in params], [m.clone() for m in mu], [v.clone() for v in nu]
    opt = tcommon.AdamW(params, lambda s: 1e-3, 1.0, 1e-2, mu_dtype=torch.bfloat16)
    ref = tcommon.AdamW(rp, lambda s: 1e-3, 1.0, 1e-2, mu_dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(3)
    grads = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    before = (ta.sq_norm.launches, ta.adamw_update.launches)
    opt.step(grads)
    assert (ta.sq_norm.launches - before[0], ta.adamw_update.launches - before[1]) == (2, 2)
    torch.testing.assert_close(opt.last_norm, ta.global_norm(grads), rtol=1e-5, atol=0)
    _plain_step(rp, rmu, rnu, grads, opt.last_norm, ref._hyper())
    _assert_close(params + opt.mu + opt.nu, rp + rmu + rnu, 1e-6)


class _PlainAdamW(tcommon.AdamW):
    """The plain version on CUDA tensors, its clip taken by another
    optimizer's last norm."""

    def __init__(self, *args, norm_of, **kw):
        super().__init__(*args, **kw)
        self.norm_of = norm_of

    def step(self, grads):
        _plain_step(self.params, self.mu, self.nu, grads, self.norm_of.last_norm, self._hyper())
        return True


@pytest.mark.cuda
def test_multisteps_inner_step_on_gpu(cuda):
    """MultiSteps(k = 2) over the kernels against MultiSteps over the plain
    version driven by the kernels' norm: the mean of two microsteps, then
    AdamW, on a clipped, an unclipped and a mixed pair; fp32 mu and no
    weight decay, as the autoencoder trainer runs it."""
    params, mu, nu = _gpu_state(cuda, torch.float32)
    rp = [p.clone() for p in params]
    inner = tcommon.AdamW(params, lambda s: 1e-3, 1.0, 0.0)
    opt = tcommon.MultiSteps(inner, 2)
    ref = tcommon.MultiSteps(_PlainAdamW(rp, lambda s: 1e-3, 1.0, 0.0, norm_of=inner), 2)
    for micro, clipped in enumerate([True, True, False, False, False, True]):
        grads = _grads(params, micro, clipped)
        assert opt.step(grads) == ref.step(grads) == (micro % 2 == 1)
        _assert_close(params + opt.mu + opt.nu + opt.acc, rp + ref.mu + ref.nu + ref.acc, 1e-6)
    assert opt.count == ref.count == 3


@pytest.mark.cuda
def test_gradients_of_another_layout_or_dtype_on_gpu(cuda):
    """Gradients as ``torch.autograd.grad`` may give them, in another layout
    or dtype than their params': the step copies each into its param's
    layout (counted) and gives the plain step's params, mu and nu."""
    params, mu, nu = _gpu_state(cuda, torch.float32)
    rp, rmu, rnu = [p.clone() for p in params], [m.clone() for m in mu], [v.clone() for v in nu]
    opt = tcommon.AdamW(params, lambda s: 1e-3, 1.0, 0.0)
    ref = tcommon.AdamW(rp, lambda s: 1e-3, 1.0, 0.0)
    grads = _grads(params, 0)
    grads[0] = grads[0].contiguous()  # params[0] is channels-last
    grads[4] = grads[4].to(torch.bfloat16)
    before = ta.adamw_update.grad_copies
    opt.step(grads)
    assert ta.adamw_update.grad_copies - before == 2
    _plain_step(rp, rmu, rnu, [g if g is None else g.float() for g in grads], opt.last_norm,
                ref._hyper())
    _assert_close(params + opt.mu + opt.nu, rp + rmu + rnu, 1e-6)
