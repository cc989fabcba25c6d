"""PyTorch port, GPU only: each hand-written CUDA kernel against its plain
PyTorch version on CUDA tensors. CUDA kernels have no CPU mode, so these
tests skip without a GPU; on one, run them with

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
