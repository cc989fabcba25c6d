"""Ring attention: exact full attention with the sequence split over the
model axis, on the port's flash kernels.

Port of ``medical_image_generation_tpu/ops/ring_attention.py`` (:33-118).
The JAX ring is ``shard_map`` + ``ppermute`` with an XLA block product; here
each of the axis's n ranks holds its S/n rows of q, k and v, and the blocks
of K and V travel round the ring (rank r sends to r + 1 and receives from
r - 1, ``dist.batch_isend_irecv`` over NCCL, or gloo on the CPU), so every
query block meets every key block once. The block products are the port's
flash kernels (``ops/flash_attention.py``: ``_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkdv``); no library attention runs.

Forward, n steps: the flash forward of (q_local, k_blk, v_blk) gives the
block's o and row logsumexp; they merge into fp32 accumulators by
log-sum-exp (``merge_block``), and the next block arrives while this one is
computed. The result is o in q's dtype and the global row lse.

Backward, the standard ring backward: K, V and fp32 dK / dV accumulators
travel round the ring together, and after n steps the accumulators are
home. At each step the rank calls ``flash_bwd_dq`` and ``flash_bwd_dkdv``
on its query block against the key block it holds, with the GLOBAL o, lse
and delta = rowsum(dO o). Why the existing kernels suffice: the kernels
recompute p_ij = exp(scale q_i k_j - lse_i) from the lse they are given;
with the global lse that is the exact probability of the full softmax, not
of the block's. So dS_ij = p_ij (dP_ij - delta_i), and each block's dQ
contribution (scale dS K_j) and dK / dV contribution (scale dS^T Q_i, P^T
dO_i) is an exact partial sum of the full gradient. Summing them over the
ring gives the full dQ, dK and dV; no kernel changes.

The per-step math is written once, over the list of blocks a process holds
and a ``rotate`` callable (``ring_forward`` / ``ring_backward``). On the
path a process holds one block and ``rotate`` is the NCCL send / receive
(``p2p_rotate``); ``chip_smoke.py`` drives the same functions over n blocks
in one process with ``rotate`` a permutation of the list.

Tolerances (``RING_TOL``, ``RING_BWD_TOL``): the JAX ring runs in fp32, and
the port's fp32 ring equals it to summation order (1e-5,
``tests/test_torch_ring.py``). In bf16 each block's o leaves the kernel
rounded to bf16 (half an ulp, 2^-9 of itself) before the fp32 merge, and
the merged o is rounded once more; dQ, dK and dV sum n bf16 kernel outputs
in fp32. The whole-sequence kernels are each within ``chip_smoke.py``'s
``FLASH_TOL`` (o: 2^-10 + 2^-7 |o|) / ``FLASH_BWD_TOL`` (2^-7 |g| + 2^-8
max |g|) of the exact values, and so is each of the ring's block products;
against the whole-sequence kernels the ring is held to twice those bounds
plus, for o, the merge's two roundings (2^-8 |o| each), the rtol rounded up
to a power of two: (2^-5, 2^-9) for o and (2^-6, 2^-7) for the gradients.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from medical_image_generation_tpu_torch.ops import flash_attention as fa
from medical_image_generation_tpu_torch.ops import kernels
from medical_image_generation_tpu_torch.parallel.comm import AxisGroup

# |x_ring - x_ref| <= rtol |x_ref| + atol (o) or + atol max |x_ref| (dq, dk, dv)
RING_TOL = {torch.bfloat16: (2.0 ** -5, 2.0 ** -9), torch.float32: (1e-5, 1e-5)}
RING_BWD_TOL = {torch.bfloat16: (2.0 ** -6, 2.0 ** -7), torch.float32: (1e-5, 1e-5)}

Rotate = Callable[[List[List[torch.Tensor]]], Callable[[], List[List[torch.Tensor]]]]


def _rows(lse, B: int, H: int):
    """(B*H, S) row statistic -> (B, S, H, 1), to scale BSHD rows."""
    return lse.reshape(B, H, -1).permute(0, 2, 1).unsqueeze(-1)


def merge_block(acc, lse, o_blk, lse_blk):
    """Fold one block's (o, lse) into the fp32 running (acc, lse) by
    log-sum-exp: returns the new (acc, lse)."""
    B, _, H, _ = acc.shape
    new = torch.logaddexp(lse, lse_blk)
    acc = (acc * _rows(torch.exp(lse - new), B, H)
           + o_blk.float() * _rows(torch.exp(lse_blk - new), B, H))
    return acc, new


def ring_forward(qs: Sequence, ks: Sequence, vs: Sequence, scale: float, n: int,
                 rotate: Rotate):
    """The ring forward over the blocks this process holds (one list entry a
    rank it stands for). ``rotate(blocks)`` starts one ring step of
    ``blocks`` (a list, one entry a held rank, of tensor lists) and returns a
    wait function giving what each held rank receives. Returns a list of (o
    in q's dtype, global lse fp32 (B*H, S/n))."""
    kv = [[k, v] for k, v in zip(ks, vs)]
    state = [None] * len(qs)
    for step in range(n):
        wait = rotate(kv) if step < n - 1 else None
        for i, (q, (k, v)) in enumerate(zip(qs, kv)):
            o_blk, lse_blk = fa._fwd(q, k, v, scale)
            state[i] = ((o_blk.float(), lse_blk) if state[i] is None
                        else merge_block(*state[i], o_blk, lse_blk))
        if wait is not None:
            kv = wait()
    return [(acc.to(q.dtype), lse) for (acc, lse), q in zip(state, qs)]


def ring_backward(qs: Sequence, ks: Sequence, vs: Sequence, os_: Sequence, lses: Sequence,
                  dos: Sequence, scale: float, n: int, rotate: Rotate):
    """The ring backward over the held blocks: K, V and the fp32 dK / dV
    accumulators rotate together; after the n-th step's products one more
    rotation of the accumulators brings them home. Returns a list of (dq,
    dk, dv) in the inputs' dtype."""
    dos = [do.to(q.dtype).contiguous() for do, q in zip(dos, qs)]
    os_ = [o.contiguous() for o in os_]
    travel = [[k, v, torch.zeros_like(k, dtype=torch.float32),
               torch.zeros_like(v, dtype=torch.float32)] for k, v in zip(ks, vs)]
    dqs = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    for step in range(n):
        for i, q in enumerate(qs):
            k, v, dk, dv = travel[i]
            dq_blk, delta = fa.flash_bwd_dq(q, k, v, os_[i], lses[i], dos[i], scale)
            dk_blk, dv_blk = fa.flash_bwd_dkdv(q, k, v, dos[i], lses[i], delta, scale)
            dqs[i].add_(dq_blk)
            dk.add_(dk_blk)
            dv.add_(dv_blk)
        if step < n - 1:
            travel = rotate(travel)()
        else:
            travel = [[None, None, *home] for home in rotate([t[2:] for t in travel])()]
    return [(dq.to(q.dtype), t[2].to(q.dtype), t[3].to(q.dtype))
            for dq, t, q in zip(dqs, travel, qs)]


def p2p_rotate(axis: AxisGroup) -> Rotate:
    """``rotate`` for one held block over the axis's process group: send to
    the next rank, receive from the previous one (``batch_isend_irecv``;
    the wait function waits on both)."""
    nxt = dist.get_global_rank(axis.group, (axis.index + 1) % axis.size)
    prv = dist.get_global_rank(axis.group, (axis.index - 1) % axis.size)

    def rotate(blocks):
        (tensors,) = blocks
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = ([dist.P2POp(dist.isend, t, nxt, axis.group) for t in sends]
               + [dist.P2POp(dist.irecv, t, prv, axis.group) for t in recvs])
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for r in reqs:
                r.wait()
            del sends[:]  # the sends' buffers are free once both sides are done
            return [recvs]

        return wait

    return rotate


def list_rotate(blocks):
    """``rotate`` for n blocks held in one process, one a rank: rank r
    receives rank r - 1's tensors."""
    return lambda: [blocks[(r - 1) % len(blocks)] for r in range(len(blocks))]


class RingAttentionFn(torch.autograd.Function):
    """softmax(scale q k^T) v over the model axis's ring; lse has no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, axis):
        ((o, lse),) = ring_forward([q], [k], [v], scale, axis.size, p2p_rotate(axis))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.axis = scale, axis
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        ((dq, dk, dv),) = ring_backward([q], [k], [v], [o], [lse], [do], ctx.scale,
                                        ctx.axis.size, p2p_rotate(ctx.axis))
        return dq, dk, dv, None, None


def ring_attention(q, k, v, axis: AxisGroup, scale: float):
    """Ring attention over this rank's rows: q, k, v are its (B, S/n, H, D)
    blocks; returns (o of those rows, their global lse)."""
    fa._check(q, k, v)
    if q.shape != k.shape:
        raise ValueError(f"the ring takes q, k and v of one shape, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    return RingAttentionFn.apply(q, k, v, float(scale), axis)


def ring_attention_sharded(q, k, v, axis: AxisGroup, scale: float):
    """Ring attention on (B, S, H, D) tensors that every rank of the axis
    holds whole: each rank takes its S/n rows of q, k and v (``scatter``: the
    backward all-gathers the rows' gradients), runs the ring, and the output
    rows are all-gathered along S (``gather``: the backward takes this
    rank's rows, with no sum). Returns the whole o. Counted in
    ``ring_attention.calls`` (``ops/kernels.py``)."""
    if q.shape[1] % axis.size:
        raise ValueError(f"sequence {q.shape[1]} not divisible by model={axis.size}")
    kernels.add("ring_attention.calls")
    o, _ = ring_attention(axis.scatter(q, 1), axis.scatter(k, 1), axis.scatter(v, 1), axis,
                          scale)
    return axis.gather(o, 1)

