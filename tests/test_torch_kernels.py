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


def nd(shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels have no CPU mode)")
    return torch.device("cuda")


# (rtol, atol) on o: fp32 summation order only; bf16 one ulp of o plus P
# rounded to bf16 before P V. lse (f32) to 1e-4 in both. A kernel that skips
# one 64-key K/V tile moves o by ~1e-3 and lse by ~1e-2 at 4096 keys.
FLASH_TOL = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2**-7, 2**-10)}


# (B, S, H, D): the U-Net's two sites, ragged S, head dims whose 64-column
# chunks do not fill the last CTA of a cluster (8, 96, 640), and D % 8 != 0
# (the bf16 kernels then run on zero-padded copies).
FLASH_SHAPES = [(2, 64, 2, 8), (1, 1000, 1, 96), (2, 512, 1, 768), (2, 4096, 1, 512),
                (1, 300, 1, 640), (1, 50, 2, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,D", FLASH_SHAPES)
def test_flash_kernel_matches_plain_on_gpu(cuda, B, S, H, D, dtype):
    q, k, v = (torch.from_numpy(nd((B, S, H, D), s)).to(cuda, dtype) for s in range(3))
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_attention(q, k, v, D ** -0.5)
    ro, rlse = tfa.flash_attention_plain(q, k, v, D ** -0.5)
    assert tfa.flash_attention.launches == before + 1
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


def _close(got, ref, rtol, atol_rel):
    g, r = got.float(), ref.float()
    bound = rtol * r.abs() + atol_rel * r.abs().max()
    assert bool(((g - r).abs() <= bound).all()), \
        f"max err {(g - r).abs().max().item():.3e}, max|ref| {r.abs().max().item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,D", FLASH_SHAPES + [(1, 300, 1, 512)])
def test_flash_backward_kernels_match_plain_on_gpu(cuda, B, S, H, D, dtype):
    q, k, v, do = (torch.from_numpy(nd((B, S, H, D), s)).to(cuda, dtype) for s in range(4))
    scale = D ** -0.5
    o, lse = tfa.flash_attention_plain(q, k, v, scale)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkdv.launches)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkdv.launches) == \
        (before[0] + 1, before[1] + 1)
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
    counters = (tfa.flash_attention, tfa.flash_bwd_dq, tfa.flash_bwd_dkdv)
    before = tuple(c.input_copies for c in counters)
    o, lse = tfa.flash_attention(q, k, v, scale)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    after = tuple(c.input_copies for c in counters)
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
    before = (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkdv.launches)
    o, _ = tfa.flash_attention(q, k, v, 0.125)
    o.float().square().sum().backward()
    after = (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches,
             tfa.flash_bwd_dkdv.launches)
    assert after == tuple(b + 1 for b in before)
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
    before = (tgn.gn_bwd_stats.launches, tgn.gn_bwd_apply.launches)
    coef, dscale, dbias = tgn.gn_bwd_stats(x, g, A, b, stats, w, G, 1e-6, silu)
    dx = tgn.gn_bwd_apply(x, g, A, b, coef, silu)
    assert (tgn.gn_bwd_stats.launches, tgn.gn_bwd_apply.launches) == \
        (before[0] + 1, before[1] + 1)
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
    before = (tgn.gn_bwd_stats.launches, tgn.gn_bwd_apply.launches)
    tgn.group_norm(x, w, b, 4, 1e-6, True).float().square().sum().backward()
    assert (tgn.gn_bwd_stats.launches, tgn.gn_bwd_apply.launches) == \
        (before[0] + 1, before[1] + 1)
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
    vec = (tgn.gn_bwd_stats.vector_launches, tgn.gn_bwd_apply.vector_launches)
    runs = []
    for _ in range(2):
        coef, dscale, dbias = tgn.gn_bwd_stats(x, g, A, b, stats, w, G, 1e-6, True)
        runs.append((coef, dscale, dbias, tgn.gn_bwd_apply(x, g, A, b, coef, True)))
    wide = C % (16 // x.element_size()) == 0 and offset == 0
    assert (tgn.gn_bwd_stats.vector_launches - vec[0],
            tgn.gn_bwd_apply.vector_launches - vec[1]) == ((2, 2) if wide else (0, 0))
    assert all(torch.equal(a_, b_) for a_, b_ in zip(*runs))
    rdx, rds, rdb = tgn.group_norm_bwd_plain(x, g, stats, w, bias, G, 1e-6, True)
    _close(runs[0][3], rdx, *GN_BWD_TOL[dtype])
    for got, ref in ((runs[0][1], rds), (runs[0][2], rdb)):
        assert (got - ref).abs().max() <= GN_PARAM_GRAD_TOL * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,C", [(2, 4096, 512), (1, 777, 24), (2, 33, 1536),
                                   (2, 2097152, 32)])
def test_groupnorm_kernels_match_plain_on_gpu(cuda, B, M, C, dtype):
    x = torch.from_numpy(nd((B, M, C), 11, 1.3, 0.7)).to(cuda, dtype)
    vec = tgn.channel_stats.vector_launches
    st = tgn.channel_stats(x)
    assert tgn.channel_stats.vector_launches == vec + 1  # C allows 16-byte loads
    ref = tgn.channel_stats_plain(x)
    assert (st - ref).abs().max() <= 1e-4 * ref.abs().max()
    G = 8 if C % 8 == 0 else 4
    w = torch.from_numpy(nd((C,), 12, 0.1, 1.0)).to(cuda)
    bias = torch.from_numpy(nd((C,), 13, 0.1)).to(cuda)
    A, b = tgn.fold_affine(ref, w, bias, G, M, 1e-6)
    rA, rb = tgn.fold_affine_plain(ref, w, bias, G, M, 1e-6)
    torch.testing.assert_close(A, rA, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b, rb, rtol=1e-5, atol=1e-5)
    for silu in (False, True):
        y, ry = tgn.affine_act(x, A, b, silu), tgn.affine_act_plain(x, A, b, silu)
        # fp32: rounding only; bf16: one ulp (exp/sigmoid rounding can flip it)
        rtol, atol = (1e-6, 1e-6) if dtype == torch.float32 else (2**-7, 2**-9)
        torch.testing.assert_close(y.float(), ry.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,C,offset", [(2, 32768, 256, 0), (2, 4099, 40, 0),
                                          (1, 1000, 64, 1), (2, 300, 37, 0)])
def test_channel_stats_is_bit_identical_across_runs_on_gpu(cuda, B, M, C, offset, dtype):
    """No float atomics and a fixed summation order, on the 16-byte path and
    on the scalar one (C not a multiple of the vector, or a misaligned
    base); both agree with the plain version."""
    flat = torch.from_numpy(nd((B * M * C + offset,), 14, 1.3, 0.7)).to(cuda, dtype)
    x = flat[offset:].view(B, M, C)
    vec = tgn.channel_stats.vector_launches
    first, second = tgn.channel_stats(x), tgn.channel_stats(x)
    assert tgn.channel_stats.vector_launches - vec == (2 if tgn._vec(x, C) else 0)
    assert torch.equal(first, second)
    ref = tgn.channel_stats_plain(x)
    assert (first - ref).abs().max() <= 1e-4 * ref.abs().max()


GN_SHAPES = [  # (M, C) of every GroupNorm on the flagship paths (batch 2)
    (32768, 256), (32768, 768), (4096, 512), (4096, 1280), (512, 768), (512, 1536),
    (32768, 128), (262144, 64), (2097152, 32)]


SLAB_SHAPES = GN_SHAPES + [(777, 24), (33, 1536), (1, 8), (4099, 40), (12345, 32), (300, 37)]


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
