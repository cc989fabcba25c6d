"""PyTorch port, GPU only: each hand-written CUDA kernel (forward and
backward) against its plain PyTorch version on CUDA tensors, and the
autograd Functions launching the backward kernels. CUDA kernels have no CPU
mode, so these tests skip without a GPU; on one, run them with

    python -m pytest tests/test_torch_kernels.py -q

This file imports no JAX, so it also runs where only PyTorch is installed."""

import numpy as np
import pytest
import torch

from medical_image_generation_tpu_torch.ops import flash_attention as tfa
from medical_image_generation_tpu_torch.ops import groupnorm as tgn
from medical_image_generation_tpu_torch.ops import kernels as tk


def nd(shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels have no CPU mode)")
    return torch.device("cuda")


FLASH_PASSES = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkdv")


def _flash(dtype, D, passes=FLASH_PASSES):
    """The table entries the flash passes take at (dtype, D): the narrow
    design's where ``takes_narrow`` holds."""
    return tuple(p + ("_narrow" if tfa.takes_narrow(dtype, D) else "") for p in passes)


def _reads(names):
    return tuple(tk.read(n) for n in names)


# (rtol, atol) on o: fp32 summation order only; bf16 one ulp of o plus P
# rounded to bf16 before P V. lse (f32) to 1e-4 in both. A kernel that skips
# one 64-key K/V tile moves o by ~1e-3 and lse by ~1e-2 at 4096 keys.
FLASH_TOL = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2**-7, 2**-10)}


# (B, S, H, D): the U-Net's two sites, ragged S, head dims whose 64-column
# chunks do not fill the last CTA of a cluster (8, 96, 640), and D % 8 != 0
# (the bf16 kernels then run on zero-padded copies); MAISI's level-3 and mid
# block site (16 heads of 32: one 64-column chunk half padding, the second
# warpgroup's all padding).
FLASH_SHAPES = [(2, 64, 2, 8), (1, 1000, 1, 96), (2, 512, 1, 768), (2, 4096, 1, 512),
                (1, 300, 1, 640), (1, 50, 2, 20), (1, 4096, 16, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,D", FLASH_SHAPES)
def test_flash_kernel_matches_plain_on_gpu(cuda, B, S, H, D, dtype):
    q, k, v = (torch.from_numpy(nd((B, S, H, D), s)).to(cuda, dtype) for s in range(3))
    (fwd,) = _flash(dtype, D, FLASH_PASSES[:1])
    before = tk.read(fwd)
    o, lse = tfa.flash_attention(q, k, v, D ** -0.5)
    ro, rlse = tfa.flash_attention_plain(q, k, v, D ** -0.5)
    assert tk.read(fwd) == before + 1
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)


# Backward (dq, dk, dv), elementwise: |g - g_plain| <= rtol * |g_plain| +
# atol * max|g_plain| per tensor. bf16: one ulp of the output, plus p and ds
# rounded to bf16 before their products (sums of random-sign terms: ~2^-9 of
# a typical element). fp32: summation order only.
FLASH_BWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 2**-8)}
# GroupNorm backward dx, elementwise, same form: bf16 one ulp of dx (fp32 sums
# in another order can flip its rounding); fp32 summation order only.
GN_BWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 1e-5)}
GN_PARAM_GRAD_TOL = 1e-4  # dscale, dbias: max abs error / max |ref|, fp32 sums
GN_BWD = ("gn_bwd_stats", "gn_bwd_apply")


def _close(got, ref, rtol, atol_rel):
    g, r = got.float(), ref.float()
    bound = rtol * r.abs() + atol_rel * r.abs().max()
    assert bool(((g - r).abs() <= bound).all()), \
        f"max err {(g - r).abs().max().item():.3e}, max|ref| {r.abs().max().item():.3e}"


# beside FLASH_SHAPES, the bf16 dK/dV pass's other cluster sizes: one CTA up
# to D = 256, a pair that pushes its partial scores to each other up to 512
# (640 and 768 take a cluster of 3)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,D", FLASH_SHAPES + [(1, 300, 1, 512), (1, 200, 1, 256),
                                                    (1, 200, 1, 300)])
def test_flash_backward_kernels_match_plain_on_gpu(cuda, B, S, H, D, dtype):
    q, k, v, do = (torch.from_numpy(nd((B, S, H, D), s)).to(cuda, dtype) for s in range(4))
    scale = D ** -0.5
    o, lse = tfa.flash_attention_plain(q, k, v, scale)
    names = _flash(dtype, D, FLASH_PASSES[1:])
    before = _reads(names)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    assert _reads(names) == (before[0] + 1, before[1] + 1)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == dtype
        _close(g, r, *FLASH_BWD_TOL[dtype])


def _views(kind, B, S, H, D, device, dtype):
    """q, k, v as the three thirds of one fused QKV tensor, or as views whose
    base pointers are 2 bytes off 16-byte alignment."""
    if kind == "qkv":
        qkv = torch.from_numpy(nd((B, S, 3 * H * D), 40)).to(device, dtype)
        return tuple(qkv[..., i * H * D:(i + 1) * H * D].view(B, S, H, D) for i in range(3))
    n = B * S * H * D
    flat = torch.from_numpy(nd((3 * n + 1,), 41)).to(device, dtype)
    return tuple(flat[1 + i * n:1 + (i + 1) * n].view(B, S, H, D) for i in range(3))


@pytest.mark.parametrize("n_inputs", [3, 5])  # forward: q, k, v; dQ pass: q, k, v, o, dO
@pytest.mark.parametrize("kind,D", [("qkv", 64), ("misaligned", 64), ("qkv", 20),
                                    ("misaligned", 8)])
def test_tma_inputs_copies_only_what_tma_cannot_describe(kind, D, n_inputs):
    q, k, v = _views(kind, 2, 16, 1, D, "cpu", torch.bfloat16)
    # o and dO of the dQ pass are contiguous: copied only with the others
    extra = tuple(torch.from_numpy(nd((2, 16, 1, D), 50 + i)).to(torch.bfloat16)
                  for i in range(n_inputs - 3))
    ins = (q, k, v, *extra)
    outs, Dp, copies = tfa.tma_inputs(D, *ins)
    copied = kind == "misaligned" or D % 8 != 0
    assert copies == (n_inputs if copied else 0) and Dp == -(-D // 8) * 8
    for c, t in zip(outs, ins):
        assert (c is t) != copied and c.data_ptr() % 16 == 0
        assert torch.equal(c[..., :D], t) and not c[..., D:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["qkv", "misaligned"])
def test_flash_strided_views_on_gpu(cuda, kind):
    """Fused-QKV thirds go to TMA as they are; misaligned views are copied
    first (and counted); both agree with the plain versions."""
    B, S, H, D = 2, 200, 2, 64
    q, k, v = _views(kind, B, S, H, D, cuda, torch.bfloat16)
    do = torch.from_numpy(nd((B, S, H, D), 42)).to(cuda, torch.bfloat16)
    scale = D ** -0.5
    counters = [f"{n}.input_copies" for n in _flash(torch.bfloat16, D)]
    before = _reads(counters)
    o, lse = tfa.flash_attention(q, k, v, scale)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    after = _reads(counters)
    expect = (3, 5, 4) if kind == "misaligned" else (0, 0, 0)
    assert tuple(a - b for a, b in zip(after, before)) == expect
    ro, rlse = tfa.flash_attention_plain(q, k, v, scale)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), ro.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    for g, r in zip(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)):
        _close(g, r, *FLASH_BWD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("pass_", ["dq", "dkdv"])
@pytest.mark.parametrize("B,S,H,D", [(2, 512, 1, 768), (1, 1000, 1, 512)])
def test_flash_backward_pass_is_bit_identical_across_runs_on_gpu(cuda, B, S, H, D, pass_):
    """Each pass sums in a fixed order (the cluster's partial scores in rank
    order), with no atomics: dq and delta, or dk and dv, the same bits twice."""
    q, k, v, do = (torch.from_numpy(nd((B, S, H, D), s)).to(cuda, torch.bfloat16)
                   for s in range(4))
    scale = D ** -0.5
    o, lse = tfa.flash_attention(q, k, v, scale)
    _, delta = tfa.flash_bwd_dq(q, k, v, o, lse, do, scale)
    if pass_ == "dq":
        first, second = (tfa.flash_bwd_dq(q, k, v, o, lse, do, scale) for _ in range(2))
    else:
        first, second = (tfa.flash_bwd_dkdv(q, k, v, do, lse, delta, scale) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(o, tfa.flash_attention(q, k, v, scale)[0])


@pytest.mark.cuda
def test_flash_function_backward_launches_kernels_on_gpu(cuda):
    """The autograd Function on CUDA: forward kernel, then both backward kernels."""
    q, k, v = (torch.from_numpy(nd((2, 128, 1, 64), s)).to(cuda, torch.bfloat16)
               .requires_grad_() for s in range(3))
    names = _flash(torch.bfloat16, 64)
    before = _reads(names)
    o, _ = tfa.flash_attention(q, k, v, 0.125)
    o.float().square().sum().backward()
    assert _reads(names) == tuple(b + 1 for b in before)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,C,G", [(2, 4096, 512, 32), (1, 777, 24, 4), (2, 33, 1536, 32)])
def test_groupnorm_backward_kernels_match_plain_on_gpu(cuda, B, M, C, G, dtype, silu):
    x = torch.from_numpy(nd((B, M, C), 21, 1.3, 0.7)).to(cuda, dtype)
    g = torch.from_numpy(nd((B, M, C), 22)).to(cuda, dtype)
    w = torch.from_numpy(nd((C,), 23, 0.1, 1.0)).to(cuda)
    bias = torch.from_numpy(nd((C,), 24, 0.1)).to(cuda)
    stats = tgn.channel_stats_plain(x)
    A, b = tgn.fold_affine_plain(stats, w, bias, G, M, 1e-6)
    before = _reads(GN_BWD)
    coef, dscale, dbias = tgn.gn_bwd_stats(x, g, A, b, stats, w, G, 1e-6, silu)
    dx = tgn.gn_bwd_apply(x, g, A, b, coef, silu)
    assert _reads(GN_BWD) == (before[0] + 1, before[1] + 1)
    rdx, rds, rdb = tgn.group_norm_bwd_plain(x, g, stats, w, bias, G, 1e-6, silu)
    _close(dx, rdx, *GN_BWD_TOL[dtype])
    for got, ref in ((dscale, rds), (dbias, rdb)):
        assert (got - ref).abs().max() <= GN_PARAM_GRAD_TOL * ref.abs().max()


@pytest.mark.cuda
def test_group_norm_function_backward_launches_kernels_on_gpu(cuda):
    x = torch.from_numpy(nd((2, 16, 4, 4, 4), 30)).to(cuda, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
    w = torch.ones(16, device=cuda, requires_grad=True)
    b = torch.zeros(16, device=cuda, requires_grad=True)
    before = _reads(GN_BWD)
    tgn.group_norm(x, w, b, 4, 1e-6, True).float().square().sum().backward()
    assert _reads(GN_BWD) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,C,G,offset", [(2, 32768, 256, 32, 0), (2, 4099, 40, 8, 0),
                                            (1, 1000, 64, 16, 1), (2, 300, 37, 1, 0)])
def test_groupnorm_backward_is_bit_identical_across_runs_on_gpu(cuda, B, M, C, G, offset, dtype):
    """Both backward passes sum in a fixed order with no float atomics, on
    the 16-byte path and on the scalar one (C not a multiple of the vector,
    or a misaligned base): coef, dscale, dbias and dx the same bits twice,
    and within tolerance of the plain versions."""
    n = B * M * C
    flat = torch.from_numpy(nd((2 * n + offset,), 25, 1.3, 0.7)).to(cuda, dtype)
    x, g = flat[offset:offset + n].view(B, M, C), flat[offset + n:].view(B, M, C)
    w = torch.from_numpy(nd((C,), 26, 0.1, 1.0)).to(cuda)
    bias = torch.from_numpy(nd((C,), 27, 0.1)).to(cuda)
    stats = tgn.channel_stats_plain(x)
    A, b = tgn.fold_affine_plain(stats, w, bias, G, M, 1e-6)
    vec_names = [f"{n}.vector_launches" for n in GN_BWD]
    vec = _reads(vec_names)
    runs = []
    for _ in range(2):
        coef, dscale, dbias = tgn.gn_bwd_stats(x, g, A, b, stats, w, G, 1e-6, True)
        runs.append((coef, dscale, dbias, tgn.gn_bwd_apply(x, g, A, b, coef, True)))
    wide = C % (16 // x.element_size()) == 0 and offset == 0
    assert tuple(n - v for n, v in zip(_reads(vec_names), vec)) == \
        ((2, 2) if wide else (0, 0))
    assert all(torch.equal(a_, b_) for a_, b_ in zip(*runs))
    rdx, rds, rdb = tgn.group_norm_bwd_plain(x, g, stats, w, bias, G, 1e-6, True)
    _close(runs[0][3], rdx, *GN_BWD_TOL[dtype])
    for got, ref in ((runs[0][1], rds), (runs[0][2], rdb)):
        assert (got - ref).abs().max() <= GN_PARAM_GRAD_TOL * ref.abs().max()


STATS_REL_TOL = 1e-4  # channel sums: max abs error / max |sum|, fp32 summation order
FOLD_REL_TOL = 1e-5   # A, b: max abs error / max |ref|, fp32 (rsqrtf, sum order)


def _stats_fold_close(got, ref):
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = STATS_REL_TOL if i == 0 else FOLD_REL_TOL
        assert g.shape == r.shape and g.dtype == torch.float32
        assert (g - r).abs().max() <= tol * r.abs().max(), ("stats", "A", "b")[i]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,C,G", [(2, 4096, 512, 32), (1, 777, 24, 4), (2, 33, 1536, 8),
                                     (2, 2097152, 32, 16), (2, 300, 40, 1)])
def test_groupnorm_kernels_match_plain_on_gpu(cuda, B, M, C, G, dtype):
    x = torch.from_numpy(nd((B, M, C), 11, 1.3, 0.7)).to(cuda, dtype)
    w = torch.from_numpy(nd((C,), 12, 0.1, 1.0)).to(cuda)
    bias = torch.from_numpy(nd((C,), 13, 0.1)).to(cuda)
    vec = tk.read("gn_stats_fold.vector_launches")
    st, A, b = tgn.stats_fold(x, w, bias, G, 1e-6)
    assert tk.read("gn_stats_fold.vector_launches") == vec + 1  # C allows 16-byte loads
    _stats_fold_close((st, A, b), tgn.stats_fold_plain(x, w, bias, G, 1e-6))
    for silu in (False, True):
        y, ry = tgn.affine_act(x, A, b, silu), tgn.affine_act_plain(x, A, b, silu)
        # fp32: rounding only; bf16: one ulp (exp/sigmoid rounding can flip it)
        rtol, atol = (1e-6, 1e-6) if dtype == torch.float32 else (2**-7, 2**-9)
        torch.testing.assert_close(y.float(), ry.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,C,G,offset", [(2, 32768, 256, 32, 0), (2, 4099, 40, 8, 0),
                                            (1, 1000, 64, 16, 1), (2, 300, 37, 1, 0),
                                            (2, 777, 24, 4, 0)])
def test_channel_stats_is_bit_identical_across_runs_on_gpu(cuda, B, M, C, G, offset, dtype):
    """No float atomics and a fixed summation order in both launches of
    stats_fold, on the 16-byte path and on the scalar one (C not a multiple
    of the vector, or a misaligned base): stats, A and b the same bits
    twice, and within tolerance of the plain version."""
    flat = torch.from_numpy(nd((B * M * C + offset,), 14, 1.3, 0.7)).to(cuda, dtype)
    x = flat[offset:].view(B, M, C)
    w = torch.from_numpy(nd((C,), 15, 0.1, 1.0)).to(cuda)
    bias = torch.from_numpy(nd((C,), 16, 0.1)).to(cuda)
    vec = tk.read("gn_stats_fold.vector_launches")
    first, second = (tgn.stats_fold(x, w, bias, G, 1e-6) for _ in range(2))
    assert tk.read("gn_stats_fold.vector_launches") - vec == (2 if tgn._vec(x, C) else 0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _stats_fold_close(first, tgn.stats_fold_plain(x, w, bias, G, 1e-6))


@pytest.mark.cuda
def test_group_norm_forward_is_two_wrapper_launches_on_gpu(cuda):
    """One GroupNorm forward: one stats_fold launch (partials, then reduce
    and fold) and one affine_act launch."""
    x = torch.from_numpy(nd((2, 32, 4, 4, 4), 31)).to(cuda, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    before = _reads(("gn_stats_fold", "gn_affine_act"))
    with torch.no_grad():
        y = tgn.group_norm(x, torch.ones(32, device=cuda), torch.zeros(32, device=cuda), 8,
                           1e-6, True)
    assert _reads(("gn_stats_fold", "gn_affine_act")) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(y).all()


GN_SHAPES = [  # (M, C) of every GroupNorm on the flagship paths (batch 2)
    (32768, 256), (32768, 768), (4096, 512), (4096, 1280), (512, 768), (512, 1536),
    (32768, 128), (262144, 64), (2097152, 32)]


# the eval's ResNet50 instance norms (one channel a group): 2D stages at 64^2 .. 8^2,
# 3D at 32^3 .. 4^3, and the widest (2048) channel count
RESNET_GN_SHAPES = [(4096, 64), (4096, 128), (1024, 128), (1024, 256), (256, 256), (256, 512),
                    (64, 512), (32768, 64), (32768, 128), (512, 256), (512, 512), (64, 2048)]
SLAB_SHAPES = GN_SHAPES + [(777, 24), (33, 1536), (1, 8), (4099, 40), (12345, 32),
                           (300, 37)] + RESNET_GN_SHAPES
# (B, M, C) of the 2D paths: the AE step (batch 24), the LDM step (48), the eval's
# sample chunks (16 and 4) and its ResNet50 over 100 images
SLAB_SHAPES_2D = [(24, 65536, 64), (24, 16384, 128), (24, 4096, 256), (24, 4096, 128),
                  (24, 3969, 256), (48, 65536, 64), (48, 4096, 768), (48, 1024, 1280),
                  (48, 256, 1536), (16, 4096, 256), (16, 256, 768), (4, 1024, 512),
                  (4, 65536, 128), (100, 4096, 64), (100, 64, 512), (100, 64, 2048)]


def _assert_slabs_tile_rows(rows, nblk, M, C, width, B, sms, per_sm):
    """Block i covers rows [i*rows, (i+1)*rows): the blocks tile [0, M)
    without gap or overlap, none empty, each a whole number of row-lane
    sweeps, and the grid fills the card where M allows (at least half the
    ``per_sm`` blocks an SM it aims for)."""
    assert rows >= 1 and nblk >= 1
    assert (nblk - 1) * rows < M <= nblk * rows
    ctv = min(C // width, 32)
    ry = 256 // ctv
    assert rows % ry == 0
    tiles = -(-(C // width) // ctv)
    if M >= 4 * ry * per_sm * sms // 2:  # rows enough for the blocks: they are there
        assert tiles * nblk * B >= per_sm * sms // 2


@pytest.mark.parametrize("M,C", SLAB_SHAPES)
@pytest.mark.parametrize("itemsize,vec", [(2, True), (4, True), (2, False)])
def test_stats_slabs_cover_every_row_once_in_order(M, C, itemsize, vec):
    """The channel-stats grid tiles the rows (``_assert_slabs_tile_rows``)."""
    B, sms = 2, 132
    width = 16 // itemsize if vec else 1
    _assert_slabs_tile_rows(*tgn._stats_slabs(B, M, C, width, sms), M, C, width, B, sms,
                            tgn._STATS_BLOCKS_PER_SM)


@pytest.mark.parametrize("pass_", ["stats", "apply"])
@pytest.mark.parametrize("M,C", SLAB_SHAPES)
@pytest.mark.parametrize("itemsize,vec", [(2, True), (4, True), (2, False)])
def test_bwd_slabs_cover_every_row_once_in_order(pass_, M, C, itemsize, vec):
    """The grid of each GroupNorm backward pass tiles the rows too: the stats
    pass writes one partial per block and sums them in block order, the
    apply writes every row of dx once."""
    B, sms = 2, 132
    width = 16 // itemsize if vec else 1
    _assert_slabs_tile_rows(*tgn._bwd_slabs(pass_, B, M, C, width, sms), M, C, width, B, sms,
                            tgn._BWD_BLOCKS_PER_SM[pass_])


@pytest.mark.parametrize("pass_", ["stats", "bwd_stats", "bwd_apply"])
@pytest.mark.parametrize("B,M,C", SLAB_SHAPES_2D)
@pytest.mark.parametrize("itemsize,vec", [(2, True), (4, True)])
def test_slabs_at_the_2d_batches_cover_every_row_once_in_order(pass_, B, M, C, itemsize, vec):
    """The three row-streaming grids (the forward stats and both backward
    passes) at the 2D paths' batches, where B alone can fill the card."""
    sms = 132
    width = 16 // itemsize if vec else 1
    if pass_ == "stats":
        got, per_sm = tgn._stats_slabs(B, M, C, width, sms), tgn._STATS_BLOCKS_PER_SM
    else:
        p = pass_[4:]
        got, per_sm = tgn._bwd_slabs(p, B, M, C, width, sms), tgn._BWD_BLOCKS_PER_SM[p]
    _assert_slabs_tile_rows(*got, M, C, width, B, sms, per_sm)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["acts", "full"])
def test_group_norm_under_remat_on_gpu(cuda, policy):
    """A bf16 ResBlock under ``remat_call`` (non-reentrant checkpointing;
    "acts" keeps the conv outputs): the same output and gradients, bit for
    bit, as without remat, with both GroupNorms' forward kernels launched
    again in the backward."""
    from medical_image_generation_tpu_torch.models.autoencoder_kl import remat_call
    from medical_image_generation_tpu_torch.models.blocks import ResBlock

    torch.manual_seed(0)
    blk = ResBlock(32, 64, 16, 1e-6, 3, dtype=torch.bfloat16, param_dtype=torch.float32,
                   device=cuda)
    x = torch.from_numpy(nd((2, 32, 16, 16, 16), 1)).to(cuda, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()

    def run(remat):
        y = remat_call(blk, x, remat)
        n = tk.read("gn_stats_fold")
        grads = torch.autograd.grad(y.float().square().sum(), [x, *blk.parameters()])
        return y, grads, tk.read("gn_stats_fold") - n

    y0, g0, n0 = run(None)
    y1, g1, n1 = run(policy)
    assert (n0, n1) == (0, 2)
    assert torch.equal(y0, y1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


# ------------------------------------------- the pixel-space DDPM's lengths


@pytest.mark.parametrize("B,S,H,D,chunk", [(2, 300, 2, 16, 64), (1, 257, 1, 24, 100),
                                           (1, 128, 1, 8, 128)])
def test_chunked_flash_references_equal_the_plain_versions(B, S, H, D, chunk):
    """CPU: the chunked plain references (the lse over every key a chunk of
    query rows at a time; dK / dV at some key rows summed over every query a
    chunk at a time) and the plain versions at a subset of query rows equal
    the whole plain versions, to fp32 summation order."""
    q, k, v, do = (torch.from_numpy(nd((B, S, H, D), s)) for s in range(4))
    scale = D ** -0.5
    o, lse = tfa.flash_attention_plain(q, k, v, scale)
    torch.testing.assert_close(tfa.flash_lse_plain_chunked(q, k, scale, chunk), lse,
                               rtol=0, atol=1e-6)
    rows = torch.tensor([0, 5, S // 2, S - 1])
    o_r, lse_r = tfa.flash_attention_plain(q[:, rows], k, v, scale)
    torch.testing.assert_close(o_r, o[:, rows], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_r, lse.reshape(B, H, S)[:, :, rows].reshape(B * H, 4),
                               rtol=0, atol=1e-6)
    dq, delta = tfa.flash_bwd_dq_plain(q, k, v, o, lse, do, scale)
    dk, dv = tfa.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale)
    lse_rows = lse.reshape(B, H, S)[:, :, rows].reshape(B * H, 4)
    dq_r, delta_r = tfa.flash_bwd_dq_plain(q[:, rows], k, v, o[:, rows], lse_rows, do[:, rows],
                                           scale)
    torch.testing.assert_close(dq_r, dq[:, rows], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(delta_r, delta.reshape(B, H, S)[:, :, rows].reshape(B * H, 4))
    keys = torch.tensor([1, S // 3, S - 2])
    dk_c, dv_c = tfa.flash_bwd_dkdv_plain_chunked(q, k, v, do, lse, delta, scale, keys, chunk)
    torch.testing.assert_close(dk_c, dk[:, keys], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv_c, dv[:, keys], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D", [(1, 32768, 1, 768), (1, 16384, 1, 512),
                                     (1, 32768, 8, 32)])
def test_flash_kernels_at_ddpm_lengths_match_the_chunked_references_on_gpu(cuda, B, S, H, D):
    """bf16 at two of the pixel-space DDPM's attention lengths (3D level 2,
    2D level 1) and at MAISI's level-2 site (8 heads of 32 over 32^3
    tokens): the lse over every row against the chunked reference, o and
    dQ at three query tiles, dK / dV at three key tiles summed over every
    query, delta over every row; the tolerances above."""
    q, k, v, do = (torch.from_numpy(nd((B, S, H, D), s)).to(cuda, torch.bfloat16)
                   for s in range(4))
    scale = D ** -0.5
    rows = torch.cat([torch.arange(s, s + 64) for s in (0, S // 2, S - 64)]).to(cuda)
    o, lse = tfa.flash_attention(q, k, v, scale)
    lse_ref = tfa.flash_lse_plain_chunked(q, k, scale)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    o_ref, _ = tfa.flash_attention_plain(q[:, rows], k, v, scale)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(o[:, rows].float(), o_ref.float(), rtol=rtol, atol=atol)
    dq, delta = tfa.flash_bwd_dq(q, k, v, o, lse_ref, do, scale)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, scale)
    r_delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * H, S)
    _close(delta, r_delta, 1e-5, 1e-5)
    lse_rows = lse_ref.reshape(B, H, S)[:, :, rows].reshape(B * H, len(rows))
    r_dq, _ = tfa.flash_bwd_dq_plain(q[:, rows], k, v, o[:, rows], lse_rows, do[:, rows], scale)
    r_dk, r_dv = tfa.flash_bwd_dkdv_plain_chunked(q, k, v, do, lse_ref, r_delta, scale, rows)
    rt, at = FLASH_BWD_TOL[torch.bfloat16]
    _close(dq[:, rows], r_dq, rt, at)
    _close(dk[:, rows], r_dk, rt, at)
    _close(dv[:, rows], r_dv, rt, at)


# (B, Sq, Sk, H, D): a context of 1, 7 and 77 tokens (shorter than one key
# tile) at the U-Net's 3D and 2D sites, keys longer than the queries (the
# D = 768 cluster sites too), and a ragged pair with three heads.
CONTEXT_SHAPES = [(2, 4096, 1, 1, 512), (2, 4096, 77, 1, 512), (2, 512, 77, 1, 768),
                  (2, 512, 4096, 1, 768), (48, 1024, 77, 1, 512), (1, 1000, 200, 3, 96),
                  (2, 40, 300, 2, 64), (1, 64, 7, 2, 20)]


def _single_key_bounds(q, k, v, do, scale):
    """Elementwise bounds on |dq| and |dk| with one key, where both vanish:
    the fp32 rounding of dP - delta (two D-term dot products of dO, with v
    and with o = v), scale * 2 gamma_D sum_d |dO_d v_d| (gamma_D = D u / (1
    - D u), u = 2^-24), times |k|, or summed against |q| over the queries."""
    D = q.shape[-1]
    gamma = D * 2.0 ** -24 / (1 - D * 2.0 ** -24)
    c = scale * 2 * gamma * (do.float().abs() * v.float().abs()).sum(-1, keepdim=True)
    return c * k.float().abs(), (c * q.float().abs()).sum(1, keepdim=True)


def _p_rounding_bound(q, k, v, scale):
    """Elementwise bound on what rounding P to bf16 before P V (u = 2^-8)
    moves o: u (P |V|), from the plain math in fp32. FLASH_TOL's 2^-10
    covers that term where many keys average its signs away; against a
    context of a few keys a few elements of o near 0 exceed it."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale, -1)
    return (2.0 ** -8 * (p @ vf.abs())).permute(0, 2, 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,D", CONTEXT_SHAPES)
def test_flash_kernels_at_another_key_length_match_plain_on_gpu(cuda, B, Sq, Sk, H, D, dtype):
    """Forward, dQ and dK/dV with keys and values of Sk tokens against Sq
    queries: each one launch, each within the tolerances above of its
    plain version (o in bf16 plus the bound of rounding P to bf16); dk and
    dv have k's shape. With one key dq and dk vanish, and each side
    must lie within the rounding bound of 0."""
    q, do = (torch.from_numpy(nd((B, Sq, H, D), s)).to(cuda, dtype) for s in (0, 3))
    k, v = (torch.from_numpy(nd((B, Sk, H, D), s)).to(cuda, dtype) for s in (1, 2))
    scale = D ** -0.5
    names = _flash(dtype, D)
    before = _reads(names)
    o, lse = tfa.flash_attention(q, k, v, scale)
    ro, rlse = tfa.flash_attention_plain(q, k, v, scale)
    p_bound = _p_rounding_bound(q, k, v, scale) if dtype == torch.bfloat16 else 0.0
    rtol, atol = FLASH_TOL[dtype]
    assert bool(((o.float() - ro.float()).abs() <= atol + rtol * ro.float().abs() + p_bound).all())
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    got = tfa.flash_attention_bwd(q, k, v, ro, rlse, do, scale)
    ref = tfa.flash_attention_bwd_plain(q, k, v, ro, rlse, do, scale)
    assert _reads(names) == tuple(n + 1 for n in before)
    bounds = _single_key_bounds(q, k, v, do, scale) if Sk == 1 else (None, None)
    for g, r, t, b in zip(got, ref, (q, k, v), (*bounds, None)):
        assert g.shape == t.shape and g.dtype == dtype
        if b is None:
            _close(g, r, *FLASH_BWD_TOL[dtype])
        else:
            assert bool(((g.float() - r.float()).abs() <= 2 * b).all())


@pytest.mark.cuda
def test_flash_takes_keys_of_another_length_on_gpu(cuda, monkeypatch):
    """k / v of 7 tokens against 64 queries (a cross-attention context)
    run forward and backward through the kernels under autograd, one launch
    each; the plain version does not run in the kernels' place."""
    q = torch.randn((2, 64, 2, 8), device=cuda, requires_grad=True)
    k, v = (torch.randn((2, 7, 2, 8), device=cuda, requires_grad=True) for _ in range(2))
    ro, _ = tfa.flash_attention_plain(q, k, v, 8 ** -0.5)
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: pytest.fail("the plain attention ran on the card"))
    names = _flash(q.dtype, 8)
    before = _reads(names)
    o, _ = tfa.flash_attention(q, k, v, 8 ** -0.5)
    o.sum().backward()
    assert _reads(names) == tuple(n + 1 for n in before)
    torch.testing.assert_close(o, ro, rtol=0.0, atol=1e-5)
    assert k.grad.shape == k.shape and v.grad.shape == v.shape


# The narrow design (csrc/flash_attn_narrow_*.cu): bf16 at head dims that
# tma_inputs pads to at most 64. D = 20 runs on copies padded to 24.
NARROW_DS = [8, 16, 20, 32, 40, 64]


def _narrow_inputs(layout, B, Sq, Sk, H, D, device):
    """q, k, v (bf16) contiguous, or as strided views of a fused projection:
    the thirds of one QKV tensor when Sk == Sq, else q alone and k, v the
    halves of one KV tensor (a context's projection)."""
    if layout == "contiguous":
        return (torch.from_numpy(nd((B, S, H, D), s)).to(device, torch.bfloat16)
                for s, S in ((60, Sq), (61, Sk), (62, Sk)))
    if Sk == Sq:
        qkv = torch.from_numpy(nd((B, Sq, 3 * H * D), 63)).to(device, torch.bfloat16)
        return (qkv[..., i * H * D:(i + 1) * H * D].view(B, Sq, H, D) for i in range(3))
    q = torch.from_numpy(nd((B, Sq, H, D), 64)).to(device, torch.bfloat16)
    kv = torch.from_numpy(nd((B, Sk, 2 * H * D), 65)).to(device, torch.bfloat16)
    return (q, *(kv[..., i * H * D:(i + 1) * H * D].view(B, Sk, H, D) for i in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused"])
@pytest.mark.parametrize("Sk", [1, 77, 1000])
@pytest.mark.parametrize("D", NARROW_DS)
def test_narrow_flash_kernels_match_plain_on_gpu(cuda, D, Sk, layout):
    """Forward, dQ and dK/dV of the narrow design at batch 2, a ragged 1000
    queries and keys of 1, 77 or 1000 tokens, q, k and v contiguous or
    strided views of a fused projection: one narrow launch of each kernel,
    each within the tolerances above of its plain version (o plus the bound
    of rounding P to bf16; with one key dq and dk vanish and are held to
    their rounding bound of 0), delta within fp32 summation order, and the
    same bits on a second run."""
    B, Sq, H = 2, 1000, 2
    q, k, v = _narrow_inputs(layout, B, Sq, Sk, H, D, cuda)
    do = torch.from_numpy(nd((B, Sq, H, D), 66)).to(cuda, torch.bfloat16)
    scale = D ** -0.5
    counters = [f"{n}_narrow" for n in FLASH_PASSES]
    before = _reads(counters)
    o, lse = tfa.flash_attention(q, k, v, scale)
    ro, rlse = tfa.flash_attention_plain(q, k, v, scale)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    bound = atol + rtol * ro.float().abs() + _p_rounding_bound(q, k, v, scale)
    assert bool(((o.float() - ro.float()).abs() <= bound).all())
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    dq, delta = tfa.flash_bwd_dq(q, k, v, ro, rlse, do, scale)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, do, rlse, delta, scale)
    assert _reads(counters) == tuple(n + 1 for n in before)
    r_dq, r_delta = tfa.flash_bwd_dq_plain(q, k, v, ro, rlse, do, scale)
    r_dk, r_dv = tfa.flash_bwd_dkdv_plain(q, k, v, do, rlse, r_delta, scale)
    _close(delta, r_delta, 1e-5, 1e-5)
    bounds = _single_key_bounds(q, k, v, do, scale) if Sk == 1 else (None, None)
    for g, r, t, b in ((dq, r_dq, q, bounds[0]), (dk, r_dk, k, bounds[1]), (dv, r_dv, v, None)):
        assert g.shape == t.shape and g.dtype == torch.bfloat16
        if b is None:
            _close(g, r, *FLASH_BWD_TOL[torch.bfloat16])
        else:
            assert bool(((g.float() - r.float()).abs() <= 2 * b).all())
    again = (*tfa.flash_attention(q, k, v, scale), *tfa.flash_bwd_dq(q, k, v, ro, rlse, do, scale),
             *tfa.flash_bwd_dkdv(q, k, v, do, rlse, delta, scale))
    assert all(torch.equal(a, b) for a, b in zip((o, lse, dq, delta, dk, dv), again))


@pytest.mark.parametrize("dtype,D,narrow", [
    (torch.bfloat16, 8, True), (torch.bfloat16, 20, True), (torch.bfloat16, 32, True),
    (torch.bfloat16, 57, True), (torch.bfloat16, 64, True), (torch.bfloat16, 65, False),
    (torch.bfloat16, 72, False), (torch.bfloat16, 96, False), (torch.bfloat16, 512, False),
    (torch.bfloat16, 768, False), (torch.float32, 8, False), (torch.float32, 32, False),
    (torch.float32, 64, False)])
def test_takes_narrow_by_the_padded_head_dim(dtype, D, narrow):
    """The narrow kernels take bf16 whose head dim, padded as tma_inputs pads
    it, is at most 64; wider heads and fp32 take the wide kernels."""
    assert tfa.takes_narrow(dtype, D) == narrow
    x = torch.zeros((1, 4, 1, D), dtype=torch.bfloat16)
    _, Dp, _ = tfa.tma_inputs(D, x)
    assert tfa.takes_narrow(torch.bfloat16, D) == (Dp <= tfa.NARROW_MAX_D)


def _counters():
    return {n: tk.read(n) for n in (*tk.KERNELS, *tk.SIDE_COUNTS)}


def _plain_call(name):
    """A CPU call of the wrapper that launches kernel ``name`` on CUDA, with
    inputs that pick that kernel there."""
    gen = torch.Generator().manual_seed(0)
    if name.startswith("flash"):
        dtype = torch.bfloat16 if name.endswith("_narrow") else torch.float32
        assert name in _flash(dtype, 32)
        q, k, v, do = (torch.randn((1, 16, 2, 32), generator=gen).to(dtype) for _ in range(4))
        o, lse = tfa.flash_attention(q, k, v, 32 ** -0.5)
        _, delta = tfa.flash_bwd_dq(q, k, v, o, lse, do, 32 ** -0.5)
        tfa.flash_bwd_dkdv(q, k, v, do, lse, delta, 32 ** -0.5)
    elif name.startswith("gn_"):
        x = torch.randn((2, 8, 2, 4, 4), generator=gen)
        x = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
        w, b = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
        tgn.group_norm(x, w, b, 4, 1e-6, True).square().sum().backward()
    else:
        from medical_image_generation_tpu_torch.training import common

        opt = common.AdamW([torch.randn((5, 3), generator=gen)], lambda s: 1e-3, 1.0, 1e-2)
        opt.step([torch.randn((5, 3), generator=gen)])


@pytest.mark.parametrize("name", list(tk.KERNELS))
def test_narrow_counters_are_left_alone_by_the_plain_path(name):
    """On the CPU the wrapper of every kernel of the table (the flash passes
    at the dtype that picks the entry's design, GroupNorm forward and
    backward, a clipped AdamW step) runs its plain version: no counter of the
    table moves, launches nor side counts."""
    before = _counters()
    _plain_call(name)
    assert _counters() == before


def test_narrow_counters_start_at_zero():
    """A fresh process imports the kernel table and its wrappers with every
    counter at 0: each kernel's launches and every side count."""
    import subprocess
    import sys

    code = ("from medical_image_generation_tpu_torch.ops import adamw, flash_attention, "
            "groupnorm, kernels, ring_attention\n"
            "print(sorted({kernels.read(n) for n in (*kernels.KERNELS, *kernels.SIDE_COUNTS)}), "
            "len(kernels.KERNELS), len(kernels.SIDE_COUNTS))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout.strip().splitlines()[-1]
    assert out == f"[0] 12 {len(tk.SIDE_COUNTS)}"
