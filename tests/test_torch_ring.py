"""PyTorch port, ring attention (``ops/ring_attention.py``) and its
dispatch (``ops/attention.py``), against the JAX ``ring_attention`` on its
8-device CPU mesh (``tests/test_ring_attention.py``,
``tests/test_multidevice.py:189-272``).

In this process: the ring's per-step block math over n in-process blocks
(``list_rotate``) against ``flash_attention_plain`` and its backward, fp32
and bf16 at the module's stated tolerances. In one group of 4 gloo ranks
spawned for the module (``torch_dist_ranks.ring_checks``): the ring over
the model axis at n = 2 and 4, forward and gradients, against JAX's ring
(fp32, 1e-5); the dispatch gate; and the ring's gradients inside the tiny
2D U-Net against the same U-Net without it; and a tiny DDPM step on the
data 2 x model 2 mesh against the replicated step at the global batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_generation_tpu.ops.ring_attention import ring_attention as jring
from medical_image_generation_tpu.parallel.mesh import get_mesh as jget_mesh
from medical_image_generation_tpu_torch.models.diffusion_unet import DiffusionUNet
from medical_image_generation_tpu_torch.ops import flash_attention as fa
from medical_image_generation_tpu_torch.ops import ring_attention as ra
from medical_image_generation_tpu_torch.parallel.comm import AxisGroup
from medical_image_generation_tpu_torch.planning.planner import create_ddpm_dict
from test_torch_parallel import check_model_parallel_step, ddpm_inputs, ddpm_reference
from torch_dist_ranks import Ranks, ring_checks
from torch_parity import nd

B, S, H, D = 2, 32, 2, 8  # the JAX gradient test's shape


def _close(got, ref, rtol, atol, what):
    got, ref = got.float(), ref.float()
    ok = (got - ref).abs() <= rtol * ref.abs() + atol
    assert bool(ok.all()), (what, float((got - ref).abs().max()))


def _close_rel(got, ref, rtol, atol, what):
    got, ref = got.float(), ref.float()
    ok = (got - ref).abs() <= rtol * ref.abs() + atol * ref.abs().max()
    assert bool(ok.all()), (what, float((got - ref).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_block_math_matches_the_whole_sequence(n, dtype):
    """n blocks rotated in this process: o, the global lse, dq, dk and dv
    against the plain whole-sequence attention and backward (in q's dtype),
    at ``RING_TOL`` / ``RING_BWD_TOL`` (lse 1e-5 in either dtype)."""
    q, k, v, do = (torch.from_numpy(nd((1, 64, 1, 16), s)).to(dtype) for s in range(4))
    scale = 16 ** -0.5
    qs, ks, vs, dos = (list(t.chunk(n, 1)) for t in (q, k, v, do))
    fwd = ra.ring_forward(qs, ks, vs, scale, n, ra.list_rotate)
    o = torch.cat([o for o, _ in fwd], 1)
    lse = torch.cat([lse.reshape(1, -1) for _, lse in fwd], 1)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
    assert o.dtype == dtype
    _close(o, o_ref, *ra.RING_TOL[dtype], "o")
    _close(lse, lse_ref, 0.0, 1e-5, "lse")
    bwd = ra.ring_backward(qs, ks, vs, [o for o, _ in fwd], [lse for _, lse in fwd], dos, scale,
                           n, ra.list_rotate)
    ref = fa.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, scale)
    for i, name in enumerate(("dq", "dk", "dv")):
        _close_rel(torch.cat([g[i] for g in bwd], 1), ref[i], *ra.RING_BWD_TOL[dtype], name)


def test_ring_refuses_an_indivisible_sequence():
    q = torch.zeros((1, 30, 1, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ra.ring_attention_sharded(q, q, q, AxisGroup(None, 0, 4), 8 ** -0.5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, the 4 ranks' results, and JAX's ring and the replicated
    DDPM step (computed here while the ranks run)."""
    q, k, v, w = (nd((B, S, H, D), 70 + i) for i in range(4))
    ddpm = create_ddpm_dict({"median_shape": (8, 16, 16), "max_shape": (8, 16, 16)}, 2)
    nl = len(ddpm["num_channels"])
    ddpm.update(num_channels=[8, 16][:nl], num_head_channels=[0, 8][:nl], norm_num_groups=4,
                num_res_blocks=1, in_channels=4, out_channels=4)
    unet = DiffusionUNet.from_config(ddpm, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(75)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / (p[0].numel() ** 0.5 if p.dim() > 1
                                                           else 10.0))
    inp = dict(q=q, k=k, v=v, w=w, unet=dict(
        params=ddpm, state={n: t.numpy() for n, t in unet.state_dict().items()},
        x=np.random.default_rng(76).uniform(0, 1, (2, 16, 16, 4)).astype(np.float32)))
    inp["ddpm"], rep_tr = ddpm_inputs()
    group = Ranks(ring_checks, 4, tmp_path_factory.mktemp("ring"), inp)
    ref = {"ddpm": ddpm_reference(inp["ddpm"], rep_tr)}
    for n in (2, 4):
        mesh = jget_mesh(model_parallel=n)

        def loss(q, k, v, mesh=mesh):
            return jnp.sum(jring(q, k, v, mesh) * jnp.asarray(w))

        args = tuple(jnp.asarray(t) for t in (q, k, v))
        ref[n] = dict(o=np.asarray(jax.jit(lambda *a, mesh=mesh: jring(*a, mesh))(*args)),
                      grads=[np.asarray(x) for x in
                             jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)])
    return ref, group.join()


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_ring_attention(ranks, n):
    """The ring over a model axis of n ranks (4 ranks: data 2 x model 2, or
    model 4), every rank holding the whole q, k, v: o and the gradients of
    sum(o * w) against JAX's ``ring_attention`` (1e-5, fp32)."""
    ref, results = ranks
    for res in results:
        r = res[n]
        np.testing.assert_allclose(r["o"], ref[n]["o"], rtol=1e-5, atol=1e-5)
        for got, want, name in zip((r["dq"], r["dk"], r["dv"]), ref[n]["grads"], "qkv"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


def test_dispatch_engages_only_under_its_gate(ranks):
    """With MEDIMGEN_RING_MIN_SEQ = 64: an active model = 2 mesh at S = 128
    takes the ring (and equals the plain attention); no active mesh, S = 64
    (the gate is strict), a model axis of 1, S = 66 over 4 ranks, and k / v
    of another length than q do not."""
    _, results = ranks
    for res in results:
        assert res["calls"] == {"engaged": 1, "no_mesh": 0, "at_gate": 0, "model_1": 0,
                                "indivisible": 0, "context": 0}
        assert res["gate_err"] < 1e-5


def test_ring_gradients_inside_the_unet(ranks):
    """The tiny 2D U-Net under an active model = 2 mesh with the gate at 32:
    the ring takes level 1's 8 x 8 = 64-token attention, and every
    parameter's gradient equals the run without the ring (gate 2^30) to
    1e-4 of the tensor's largest: the scatter / gather pair around the ring
    neither sums its gradients over the ranks nor drops the other ranks'
    rows."""
    _, results = ranks
    for res in results:
        u = res["unet"]
        assert u["n_ring"] > 0 and u["n_ref"] == 0
        assert max(u["err"].values()) < 1e-4, max(u["err"].items(), key=lambda kv: kv[1])


def test_data_and_model_parallel_step_matches_the_replicated_step(ranks):
    """A tiny DDPM step on the data 2 x model 2 mesh, a row a data
    coordinate, the ring inside the sharded attention at the 64-token
    sites: the gradient mean over the data axis wraps the Megatron and ring
    collectives of the model axis. Each rank against the one-process step at
    the global batch (``check_model_parallel_step``); the same params on
    every rank."""
    ref, results = ranks
    for rank, res in enumerate(results):
        check_model_parallel_step(res["ddpm_2x2"], ref["ddpm"], f"rank {rank}")
        for n, p in res["ddpm_2x2"]["params"].items():
            np.testing.assert_array_equal(p, results[0]["ddpm_2x2"]["params"][n], err_msg=n)
