"""PyTorch port, ops: the plain versions of the hand-written kernels against
the JAX package's Pallas kernels (interpret mode on the CPU) and its
GroupNorm module, in fp32, and the dispatcher's routing. The kernels
themselves are checked on a GPU by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.models import blocks as jblocks
from medical_image_generation_tpu.ops import pallas_attention as jpa
from medical_image_generation_tpu.ops import pallas_groupnorm as jgn
from medical_image_generation_tpu_torch.ops import attention as tattn
from medical_image_generation_tpu_torch.ops import flash_attention as tfa
from medical_image_generation_tpu_torch.ops import groupnorm as tgn
from torch_parity import internal, nd, public

F32_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, summation order only


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("B,S,H,D", [(1, 64, 1, 16), (2, 8, 2, 8), (1, 40, 1, 96),
                                     (2, 128, 2, 32)])
def test_flash_plain_matches_pallas_kernel(B, S, H, D):
    q, k, v = (nd((B, S, H, D), s) for s in range(3))
    scale = D ** -0.5
    ref = np.asarray(jpa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    _, ref_lse = jpa._flash_forward(*(jpa._to_3d(jnp.asarray(a)) for a in (q, k, v)), scale)
    o, lse = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    np.testing.assert_allclose(o.numpy(), ref, **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, 0], **F32_TOL)


def test_flash_takes_strided_qkv_views():
    """q/k/v as thirds of a fused QKV projection (row stride 3C)."""
    qkv = torch.from_numpy(nd((2, 24, 3 * 32), 4))
    q, k, v = (t.unflatten(-1, (2, 16)) for t in qkv.split(32, dim=-1))
    o, _ = tfa.flash_attention(q, k, v, 0.25)
    o2, _ = tfa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), 0.25)
    torch.testing.assert_close(o, o2)


def test_dispatcher_routes_cpu_to_plain_and_rejects_others():
    q = torch.from_numpy(nd((1, 16, 1, 8)))
    torch.testing.assert_close(tattn.dot_product_attention(q, q, q),
                               tfa.flash_attention_plain(q, q, q, 8 ** -0.5)[0])
    with pytest.raises(TypeError):
        tattn.dot_product_attention(q.half(), q.half(), q.half())
    m = torch.empty((1, 16, 1, 8), device="meta")
    with pytest.raises(ValueError):
        tattn.dot_product_attention(m, m, m)


# ---------------------------------------------------------------- groupnorm

@pytest.mark.parametrize("B,M,C", [(2, 256, 128), (2, 96, 24), (1, 1000, 32)])
def test_channel_stats_plain_matches_pallas(B, M, C):
    x = nd((B, M, C), 1, 1.3, 0.7)
    got = tgn.channel_stats_plain(torch.from_numpy(x)).numpy()
    for fn in (jgn.lane_stats, jgn.lane_stats_any):
        np.testing.assert_allclose(got, np.asarray(fn(jnp.asarray(x))), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("B,M,C,G", [(2, 256, 128, 32), (2, 96, 24, 4), (1, 1000, 32, 8),
                                     (2, 512, 64, 16)])
def test_stats_fold_matches_pallas_stats_and_fold(B, M, C, G):
    """stats_fold on the CPU against JAX lane_stats + _fold_affine, and the
    whole forward (stats_fold, then affine_act) against _gn_fwd_value, fp32.
    Channel sums of up to 1000 values of |x| ~ 2: 1e-5 relative plus 1e-3
    absolute (summation order); A, b and y: summation order only."""
    x, w, b = nd((B, M, C), 11, 1.3, 0.7), nd((C,), 12, 0.1, 1.0), nd((C,), 13, 0.1)
    stats, A, bb = tgn.stats_fold(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), G, 1e-6)
    jstats = jgn.lane_stats(jnp.asarray(x))
    jA, jb = jgn._fold_affine(jstats[:, 0], jstats[:, 1], jnp.asarray(w), jnp.asarray(b), G, 1,
                              M, 1e-6)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), **F32_TOL)
    np.testing.assert_allclose(bb.numpy(), np.asarray(jb), **F32_TOL)
    for silu in (False, True):
        y, s1, s2 = jgn._gn_fwd_value(jnp.asarray(x).reshape(B, M, 1, 1, C), jnp.asarray(w),
                                      jnp.asarray(b), G, 1, 1e-6, jnp.float32, silu)
        got = tgn.affine_act(torch.from_numpy(x), A, bb, silu)
        np.testing.assert_allclose(got.numpy(), np.asarray(y).reshape(B, M, C), rtol=1e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(stats.numpy(), np.stack([s1, s2], 1), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("silu", [False, True])
def test_affine_act_and_fold_match_pallas(silu):
    B, M, C, G = 2, 128, 64, 8
    x = nd((B, M, C), 2, 1.3, 0.7)
    w, b = nd((C,), 3, 0.1, 1.0), nd((C,), 4, 0.1)
    s = x.sum(1, dtype=np.float64).astype(np.float32)
    s2 = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    jA, jb = jgn._fold_affine(jnp.asarray(s), jnp.asarray(s2), jnp.asarray(w), jnp.asarray(b),
                              G, 1, M, 1e-6)
    tA, tb = tgn.fold_affine_plain(torch.from_numpy(np.stack([s, s2], 1)), torch.from_numpy(w),
                                   torch.from_numpy(b), G, M, 1e-6)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), **F32_TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **F32_TOL)
    _, fA, fb = tgn.stats_fold(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), G,
                               1e-6)
    np.testing.assert_allclose(fA.numpy(), np.asarray(jA), **F32_TOL)
    np.testing.assert_allclose(fb.numpy(), np.asarray(jb), **F32_TOL)
    ref = jgn.affine_act(jnp.asarray(x), jA, jb, "silu" if silu else "none", jnp.float32)
    got = tgn.affine_act(torch.from_numpy(x), tA, tb, silu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def _jax_group_norm(x, w, b, G, dtype, silu):
    mod = jblocks.GroupNorm(G, 1e-6, dtype)
    y = mod.apply({"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}},
                  jnp.asarray(x).astype(dtype))
    return np.asarray((jax.nn.silu(y) if silu else y).astype(jnp.float32))


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,G", [((2, 4, 6, 8, 16), 4), ((1, 3, 5, 7, 32), 8),
                                     ((2, 6, 10, 12), 3)])
def test_group_norm_matches_jax_module_fp32(shape, G, silu):
    C = shape[-1]
    x, w, b = nd(shape, 5, 1.3, 0.7), nd((C,), 6, 0.1, 1.0), nd((C,), 7, 0.1)
    got = tgn.group_norm(internal(x), torch.from_numpy(w), torch.from_numpy(b), G, 1e-6, silu)
    np.testing.assert_allclose(public(got), _jax_group_norm(x, w, b, G, jnp.float32, silu),
                               rtol=1e-5, atol=2e-5)


def test_group_norm_bf16_within_bf16_rounding_of_jax_module():
    """The port applies the folded affine in fp32 and rounds once (as the
    Pallas affine_act); the JAX module rounds A, b, x*A, x*A + b and the SiLU
    output to bf16. Tolerance: 2^-5 relative (eight bf16 half-ulps) and 2^-5
    absolute for the cancellation in x*A + b at |x*A| <= 4."""
    shape, G = (2, 4, 6, 8, 32), 8
    x, w, b = nd(shape, 8, 1.3, 0.7), nd((32,), 9, 0.1, 1.0), nd((32,), 10, 0.1)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = tgn.group_norm(internal(xb).to(torch.bfloat16), torch.from_numpy(w),
                         torch.from_numpy(b), G, 1e-6, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(public(got), _jax_group_norm(xb, w, b, G, jnp.bfloat16, True),
                               rtol=2**-5, atol=2**-5)


def test_group_norm_rejects_non_channels_last():
    x = torch.from_numpy(nd((1, 8, 4, 4, 4)))  # contiguous NCDHW, not channels-last
    with pytest.raises(ValueError, match="channels-last"):
        tgn.group_norm(x, torch.ones(8), torch.zeros(8), 4)
