"""PyTorch port, attention to a context of its own length and width against
the JAX package, fp32 on the CPU: the plain flash forward, lse and the
three gradients against ``jax.nn.dot_product_attention`` and ``jax.vjp`` at
Sq != Sk (a context of 1, 7 or 40 tokens); the tiny conditioned U-Net built
with ``context_dim`` against the flax ``DiffusionUNet`` initialised and
applied with a (B, Sk, E) context (forward, and the gradients of x, the
context and every parameter, in 3D with ControlNet residuals and in 2D);
the converter's refusal of that tree for a U-Net without
``context_dim``; and what the JAX Pallas flash kernel does with keys of
another length (a JAX-side finding, pinned, not repaired)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.models.diffusion_unet import DiffusionUNet as JDiffusionUNet
from medical_image_generation_tpu.ops.pallas_attention import flash_attention as jax_pallas_flash
from medical_image_generation_tpu_torch import convert
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.ops import flash_attention as fa
from medical_image_generation_tpu_torch.planning.planner import (
    compute_output_size,
    flagship_configs,
)
from test_torch_conditioning import TOL, _grad_close, _skip_shapes
from torch_parity import init_shapes, nd, rand_params

FLASH_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 on both sides: summation order only
CTX_LEN, CTX_DIM = 7, 12  # the context: 7 tokens of a width no attention site has


@pytest.mark.parametrize("H", [1, 2])
@pytest.mark.parametrize("Sk", [1, 7, 40])
@pytest.mark.parametrize("Sq", [24, 64])
def test_plain_flash_at_another_key_length_matches_jax_attention(Sq, Sk, H):
    """o, the row lse and dq, dk, dv of ``flash_attention`` (the plain
    versions on the CPU, the autograd Function's backward) against
    ``jax.nn.dot_product_attention``, its logsumexp and ``jax.vjp``, with
    keys and values of Sk tokens against Sq queries."""
    D, scale = 8, 0.3
    q, k, v, do = (nd((2, s, H, D), i) for i, s in enumerate((Sq, Sk, Sk, Sq)))

    @jax.jit
    def jax_ref(a, b, c, cot):
        o, vjp = jax.vjp(lambda *t: jax.nn.dot_product_attention(*t, scale=scale), a, b, c)
        lse = jax.nn.logsumexp(jnp.einsum("bqhd,bkhd->bhqk", a, b) * scale, axis=-1)
        return o, lse.reshape(2 * H, Sq), vjp(cot)

    ref, ref_lse, ref_grads = jax_ref(q, k, v, do)

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = fa.flash_attention(qt, kt, vt, scale)
    assert o.shape == (2, Sq, H, D) and lse.shape == (2 * H, Sq)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref), **FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **FLASH_TOL)
    (o * torch.from_numpy(do)).sum().backward()
    for name, t, r in zip("qkv", (qt, kt, vt), ref_grads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), err_msg=f"d{name}",
                                   **FLASH_TOL)


def _context_pair(spatial_dims, seed=21):
    """(flax module, flax params, port module, latent, ddpm_params, context)
    of the tiny conditioned U-Net (two transformer layers a site), the flax
    tree initialised with a (2, 7, 12) context and the port built with
    ``context_dim=12``, both with the same seeded weights."""
    vae_p, ddpm_p, image = flagship_configs(tiny=True, spatial_dims=spatial_dims)
    ddpm_p = dict(ddpm_p, with_conditioning=True, transformer_num_layers=2)
    latent = compute_output_size(image, vae_p["downsample_parameters"])
    ctx = nd((2, CTX_LEN, CTX_DIM), seed + 1)
    jm = JDiffusionUNet.from_config(ddpm_p, dtype=jnp.float32)
    x0 = jnp.zeros((2, *latent, ddpm_p["in_channels"]))
    params = rand_params(init_shapes(jm, jax.random.PRNGKey(0), x0, jnp.zeros((2,), jnp.int32),
                                     context=jnp.asarray(ctx)), seed)
    tm = DiffusionUNet.from_config(ddpm_p, dtype=torch.float32, device="cpu",
                                   context_dim=CTX_DIM)
    tm.load_state_dict(convert.unet_from_flax(params))
    return jm, params, tm, latent, ddpm_p, ctx


@pytest.mark.parametrize("spatial_dims,residuals", [(3, True), (2, False)],
                         ids=["3d-controlnet", "2d"])
def test_unet_with_a_context_matches_flax(spatial_dims, residuals):
    """The conditioned U-Net attending to a context of 7 tokens of width 12
    at every site (key / value projections 12 -> 32 and 12 -> 64): the
    output, and the gradients of x, the context and every parameter
    against ``jax.vjp`` of ``DiffusionUNet.apply(..., context=c)`` (one
    jitted call: the op-by-op vjp takes twice as long on the CPU); in 3D
    with ControlNet residuals on every skip and the mid block."""
    jm, params, tm, latent, ddpm_p, ctx = _context_pair(spatial_dims)
    kv = {m.Dense_1.in_features for n, m in tm.named_modules() if n.endswith("CrossAttention_1")}
    assert kv == {CTX_DIM}
    x = nd((2, *latent, ddpm_p["in_channels"]), 23)
    t = np.array([3, 700], np.int32)
    kw_j, kw_t = {}, {}
    if residuals:
        skips, mid = _skip_shapes(latent, ddpm_p, 2)
        down = [nd(s, 30 + i, 0.5) for i, s in enumerate(skips)]
        mid_r = nd(mid, 29, 0.5)
        kw_j = dict(down_block_additional_residuals=[jnp.asarray(r) for r in down],
                    mid_block_additional_residual=jnp.asarray(mid_r))
        kw_t = dict(down_block_additional_residuals=[torch.from_numpy(r) for r in down],
                    mid_block_additional_residual=torch.from_numpy(mid_r))

    def f(p, a, c):
        return jm.apply({"params": p}, a, jnp.asarray(t), context=c, **kw_j)

    @jax.jit
    def jax_ref(p, a, c, cot):
        out, vjp = jax.vjp(f, p, a, c)
        return out, vjp(cot)

    cot = nd((2, *latent, ddpm_p["out_channels"]), 24)
    ref, (gp, gx, gc) = jax_ref(params, x, ctx, cot)

    xt, ct = torch.from_numpy(x).requires_grad_(), torch.from_numpy(ctx).requires_grad_()
    out = tm(xt, torch.from_numpy(t).long(), context=ct, **kw_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    with torch.no_grad():  # the context moves the output
        other = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                   context=torch.from_numpy(nd(ctx.shape, 25)), **kw_t)
    assert np.abs(other.numpy() - np.asarray(ref)).max() > 1e-3
    (out * torch.from_numpy(cot)).sum().backward()
    _grad_close(xt.grad.numpy(), np.asarray(gx), "x")
    _grad_close(ct.grad.numpy(), np.asarray(gc), "context")
    ref_p = convert.unet_from_flax(jax.tree_util.tree_map(np.asarray, gp))
    named = dict(tm.named_parameters())
    assert set(named) == set(ref_p)
    for name, r in ref_p.items():
        _grad_close(named[name].grad.numpy(), r.numpy(), name)


def test_context_tree_needs_context_dim():
    """The flax tree initialised with a context of width 12 loads into
    ``context_dim=12`` (above) and fails on shape in a U-Net built without
    it, whose key / value projections map each site's own channels; and
    ``context_dim`` without ``with_conditioning`` is refused."""
    _, params, _, _, ddpm_p, _ = _context_pair(3)
    plain = DiffusionUNet.from_config(ddpm_p, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        plain.load_state_dict(convert.unet_from_flax(params))
    with pytest.raises(ValueError, match="with_conditioning"):
        DiffusionUNet.from_config(dict(ddpm_p, with_conditioning=False), dtype=torch.float32,
                                  device="cpu", context_dim=CTX_DIM)


def test_jax_pallas_flash_takes_one_sequence_length():
    """JAX-side finding, not repaired: the JAX Pallas flash kernel walks
    q's length over the keys (``pallas_attention.py:146-151``,
    ``seq_len=S``). In interpret mode, keys of more tokens than the queries
    give attention to the first Sq keys only (wrong, silently), and keys of
    fewer raise. ``ops/attention.py`` gates the kernel on q's shape alone
    and falls back to XLA on an exception, so a context longer than 8192
    queries would take the silent path. The port's plain versions (and
    kernels) take any Sk."""
    D, scale = 128, 128 ** -0.5
    q = jnp.asarray(nd((1, 64, 1, D), 50))
    k, v = (jnp.asarray(nd((1, 128, 1, D), s)) for s in (51, 52))
    o = jax_pallas_flash(q, k, v, scale)
    full = jax.nn.dot_product_attention(q, k, v, scale=scale)
    first = jax.nn.dot_product_attention(q, k[:, :64], v[:, :64], scale=scale)
    assert float(jnp.abs(o - full).max()) > 0.1
    np.testing.assert_allclose(np.asarray(o), np.asarray(first), rtol=1e-5, atol=1e-5)
    port, _ = fa.flash_attention(*(torch.tensor(np.asarray(a)) for a in (q, k, v)), scale)
    np.testing.assert_allclose(port.numpy(), np.asarray(full), rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match="slice_sizes"):
        jax_pallas_flash(q, k[:, :16], v[:, :16], scale)
