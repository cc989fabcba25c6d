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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,D", [(2, 64, 2, 8), (1, 1000, 1, 96), (2, 512, 1, 768),
                                     (1, 50, 2, 20)])  # D % 8 != 0: element loads
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
@pytest.mark.parametrize("B,S,H,D", [(2, 64, 2, 8), (1, 1000, 1, 96), (2, 512, 1, 768),
                                     (1, 50, 2, 20), (1, 300, 1, 512)])
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
@pytest.mark.parametrize("B,M,C", [(2, 4096, 512), (1, 777, 24), (2, 33, 1536)])
def test_groupnorm_kernels_match_plain_on_gpu(cuda, B, M, C, dtype):
    x = torch.from_numpy(nd((B, M, C), 11, 1.3, 0.7)).to(cuda, dtype)
    st = tgn.channel_stats(x)
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
