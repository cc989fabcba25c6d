"""PyTorch port, training ops: the plain versions of the backward kernels
(flash attention, GroupNorm(+SiLU)) against the JAX package (the Pallas
backward in interpret mode, autodiff of the flax GroupNorm, the closed-form
``_gn_vjp_bwd``), the autograd Functions' wiring, and the optimizer and LR
schedules against optax. fp32 on the CPU. The kernels themselves are
checked on a GPU by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medical_image_generation_tpu.models import blocks as jblocks
from medical_image_generation_tpu.ops import pallas_attention as jpa
from medical_image_generation_tpu.ops import pallas_groupnorm as jgn
from medical_image_generation_tpu.training import common as jcommon
from medical_image_generation_tpu_torch.models import blocks as tblocks
from medical_image_generation_tpu_torch.ops import attention as tattn
from medical_image_generation_tpu_torch.ops import flash_attention as tfa
from medical_image_generation_tpu_torch.ops import groupnorm as tgn
from medical_image_generation_tpu_torch.training import common as tcommon
from torch_parity import internal, nd

# fp32 gradients reduced over a few hundred keys / spatial positions in
# another order than XLA: summation order only
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ------------------------------------------------------------ flash backward

@pytest.mark.parametrize("B,S,H,D", [(1, 256, 2, 32), (2, 384, 1, 96), (1, 384, 3, 16)])
def test_flash_bwd_plain_matches_pallas_backward(B, S, H, D):
    """Several 128-key blocks of the Pallas backward (interpret mode), H > 1."""
    q, k, v, do = (nd((B, S, H, D), s) for s in range(4))
    scale = D ** -0.5
    q3, k3, v3, do3 = (jpa._to_3d(jnp.asarray(a)) for a in (q, k, v, do))
    o3, lse = jpa._flash_forward(q3, k3, v3, scale)
    ref = jpa._flash_backward(q3, k3, v3, o3, lse, do3, scale)
    o = np.asarray(jpa._from_3d(o3, B, H))
    got = tfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), _t(o),
                                        _t(np.asarray(lse)[:, 0]), _t(do), scale)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(jpa._from_3d(r, B, H)), **GRAD_TOL)


@pytest.mark.parametrize("B,S,H,D", [(2, 256, 1, 32), (1, 384, 2, 24)])
def test_flash_function_grads_match_jax_grad(B, S, H, D):
    """The port's autograd Function on the CPU against jax.vjp of the JAX
    package's flash_attention (its custom_vjp)."""
    q, k, v, do = (nd((B, S, H, D), 10 + s) for s in range(4))
    _, vjp = jax.vjp(lambda a, b, c: jpa.flash_attention(a, b, c, D ** -0.5),
                     *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o, _ = tfa.flash_attention(tq, tk, tv, D ** -0.5)
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL)


def test_flash_function_backward_equals_autograd_of_plain():
    q, k, v = (_t(nd((2, 40, 3, 16), s)).requires_grad_() for s in range(3))
    do = _t(nd((2, 40, 3, 16), 3))
    got = torch.autograd.grad(tfa.flash_attention(q, k, v, 0.25)[0], (q, k, v), do)
    ref = torch.autograd.grad(tfa.flash_attention_plain(q, k, v, 0.25)[0], (q, k, v), do)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- GN backward

def _gn_inputs(shape, seed):
    C = shape[-1]
    return (nd(shape, seed, 1.3, 0.7), nd((C,), seed + 1, 0.1, 1.0), nd((C,), seed + 2, 0.1),
            nd(shape, seed + 3))


def _port_gn_bwd(x, w, b, g, G, silu):
    B, C = x.shape[0], x.shape[-1]
    x2, g2 = _t(x.reshape(B, -1, C)), _t(g.reshape(B, -1, C))
    dx, ds, db = tgn.group_norm_bwd_plain(x2, g2, tgn.channel_stats_plain(x2), _t(w), _t(b),
                                          G, 1e-6, silu)
    return dx.numpy().reshape(x.shape), ds.numpy(), db.numpy()


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,G", [((2, 4, 6, 8, 16), 4), ((1, 3, 5, 7, 32), 8),
                                     ((2, 6, 10, 12), 3)])
def test_gn_bwd_plain_matches_jax_vjp_of_module(shape, G, silu):
    x, w, b, g = _gn_inputs(shape, 20)

    def f(xx, ss, bb):
        y = jblocks.GroupNorm(G, 1e-6, jnp.float32).apply(
            {"params": {"scale": ss, "bias": bb}}, xx)
        return jax.nn.silu(y) if silu else y

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, w, b)))
    ref = vjp(jnp.asarray(g))
    for got, r in zip(_port_gn_bwd(x, w, b, g, G, silu), ref):
        np.testing.assert_allclose(got, np.asarray(r), rtol=2e-4, atol=5e-5)


@pytest.mark.parametrize("silu", [False, True])
def test_gn_bwd_plain_matches_closed_form_vjp(silu, monkeypatch):
    """Against ``_gn_vjp_bwd`` in its analytic-flat mode at pack 1."""
    monkeypatch.setenv("MEDIMGEN_GN_BWD", "analytic-flat")
    shape, G = (2, 4, 8, 8, 32), 8
    x, w, b, g = _gn_inputs(shape, 30)
    _, vjp = jax.vjp(lambda xx, ss, bb: jgn.group_norm_packed(
        xx, ss, bb, G, 1, 1e-6, jnp.float32, silu), *(jnp.asarray(a) for a in (x, w, b)))
    ref = vjp(jnp.asarray(g))
    # the same closed form on both sides; fp32 reductions in another order
    for got, r in zip(_port_gn_bwd(x, w, b, g, G, silu), ref):
        np.testing.assert_allclose(got, np.asarray(r), rtol=2e-4, atol=5e-5)


@pytest.mark.parametrize("silu", [False, True])
def test_gn_function_backward_equals_autograd_of_plain(silu):
    x = internal(nd((2, 4, 6, 8, 16), 40, 1.3, 0.7)).requires_grad_()
    w = _t(nd((16,), 41, 0.1, 1.0)).requires_grad_()
    b = _t(nd((16,), 42, 0.1)).requires_grad_()
    gy = internal(nd((2, 4, 6, 8, 16), 43))
    got = torch.autograd.grad(tgn.group_norm(x, w, b, 4, 1e-6, silu), (x, w, b), gy)
    x2 = x.permute(0, 2, 3, 4, 1).reshape(2, -1, 16)
    A, bb = tgn.fold_affine_plain(tgn.channel_stats_plain(x2), w, b, 4, x2.shape[1], 1e-6)
    y2 = tgn.affine_act_plain(x2, A, bb, silu)
    ref = torch.autograd.grad(y2, (x, w, b), gy.permute(0, 2, 3, 4, 1).reshape(2, -1, 16))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=2e-6)


def test_gn_bwd_takes_a_non_channels_last_gradient():
    """A contiguous NCDHW cotangent is made channels-last by one counted copy."""
    x = internal(nd((1, 3, 4, 5, 8), 50)).requires_grad_()
    w, b = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
    y = tgn.group_norm(x, w, b, 2, 1e-6, True)
    gy = _t(nd((1, 8, 3, 4, 5), 51))  # NCDHW-contiguous
    before = tgn.gn_bwd_apply.grad_copies
    got = torch.autograd.grad(y, (x, w, b), gy, retain_graph=True)
    assert tgn.gn_bwd_apply.grad_copies == before + 1
    ref = torch.autograd.grad(y, (x, w, b), gy.contiguous(memory_format=torch.channels_last_3d))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r)


# ------------------------------------------------------------------- wiring

def test_kernel_outputs_carry_the_port_functions():
    """Pins a repaired fault: kernel outputs had no grad_fn, so GroupNorm
    scales and everything behind a GroupNorm got no gradient on CUDA."""
    x = internal(nd((1, 2, 3, 4, 8), 60)).requires_grad_()
    y = tgn.group_norm(x, torch.ones(8), torch.zeros(8), 2, 1e-6, True)
    assert type(y.grad_fn).__name__ == "GroupNormFnBackward"
    q = _t(nd((1, 16, 1, 8), 61)).requires_grad_()
    o = tattn.dot_product_attention(q, q, q)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    att = tblocks.AttentionBlock(8, -1, 2)
    att(internal(nd((1, 2, 3, 4, 8), 62))).sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in att.parameters())


def test_inference_launch_path_unchanged_under_no_grad():
    """Under no_grad the Functions run only their forwards."""
    x = internal(nd((1, 2, 3, 4, 8), 63))
    with torch.no_grad():
        y = tgn.group_norm(x, torch.ones(8), torch.zeros(8), 2, 1e-6, True)
    assert y.grad_fn is None and y.shape == x.shape


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("mu_dtype,wd", [("bfloat16", 1e-2), ("float32", 1e-2),
                                         ("bfloat16", 0.0)])
def test_clip_adamw_matches_optax_over_five_steps(mu_dtype, wd):
    """clip_by_global_norm(1) + AdamW(bf16 mu) against common.make_optimizer
    on the same gradient arrays, clipped and unclipped steps alternating:
    fp32 rounding only (bit-equal here)."""
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (11,), (3, 3, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jmu = jnp.bfloat16 if mu_dtype == "bfloat16" else None
    tx = jcommon.make_optimizer(jcommon.make_lr_schedule(2e-3, None, None, 10), 1.0, 1,
                                weight_decay=wd, mu_dtype=jmu)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [_t(p.copy()) for p in params]
    opt = tcommon.AdamW(tp, tcommon.make_lr_schedule(2e-3, None, None, 10), 1.0, wd,
                        mu_dtype=tcommon.mu_dtype_from_config({"adam_mu_dtype": mu_dtype}))
    for i in range(5):
        gs = [rng.standard_normal(s).astype(np.float32) * (0.05 if i % 2 else 3.0)
              for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([_t(g) for g in gs])
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9)
    assert opt.mu[0].dtype == (torch.bfloat16 if mu_dtype == "bfloat16" else torch.float32)


def test_clip_by_global_norm_matches_optax():
    gs = [nd((4, 5), 70, 2.0), nd((7,), 71, 2.0)]
    for scale in (0.01, 1.0):
        ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) * scale for g in gs], None)
        got = [_t(g) * scale for g in gs]
        tcommon.clip_by_global_norm(got, 1.0)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,params", [
    (None, None),
    ("LinearLR", {"start_factor": 1.0, "end_factor": 0.1, "total_iters": 3}),
    ("PolynomialLR", {"total_iters": 3, "power": 0.9}),
])
def test_lr_schedules_match_jax(name, params):
    j = jcommon.make_lr_schedule(2e-5, name, params, 4)
    t = tcommon.make_lr_schedule(2e-5, name, params, 4)
    for step in (0, 1, 5, 11, 12, 20):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, atol=0)


def test_ema_update_and_mu_dtype_from_config():
    e, p = [_t(np.ones(3, np.float32))], [_t(np.full(3, 3.0, np.float32))]
    tcommon.ema_update(e, p, 0.9)
    np.testing.assert_allclose(e[0].numpy(), 1.2, rtol=1e-6)
    assert tcommon.mu_dtype_from_config({}) == torch.bfloat16
    assert tcommon.mu_dtype_from_config({"adam_mu_dtype": "fp32"}) is None
    with pytest.raises(ValueError):
        tcommon.mu_dtype_from_config({"adam_mu_dtype": "fp16"})
