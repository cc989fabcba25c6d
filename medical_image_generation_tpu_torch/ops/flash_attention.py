"""Flash attention, forward and backward: the hand-written kernels, their
plain versions, and the ``torch.autograd.Function`` that joins them.

Ports of the TPU kernels ``_flash_forward`` (``medical_image_generation_tpu/
ops/pallas_attention.py:144-184``) and ``_flash_backward`` (``:310-358``).
The kernels are ``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``
(the wide design, which splits the head dim over warpgroups and clusters),
and ``csrc/flash_attn_narrow_fwd.cu`` and ``csrc/flash_attn_narrow_bwd.cu``
(the narrow design, one warpgroup holding all of a head dim up to 64); their
source notes give the designs and the bounds. ``takes_narrow`` says which
design a call takes: bf16 at a head dim padded to at most 64 the narrow one,
everything else the wide one.

``flash_attention(q, k, v, scale)`` takes BSHD tensors (batch, seq, heads,
head_dim) and returns ``(o, lse)``: o in BSHD (contiguous, q's dtype) and the
fp32 row logsumexp of shape (B*H, Sq), which carries no gradient. k and v
have one shape, with q's batch, heads and head dim and a sequence length Sk
of their own (a cross-attention context of 1 or 77 tokens, or more than
Sq): the kernels and the plain versions take any Sq >= 1 and Sk >= 1. q, k
and v may be strided views (for example the three thirds of a fused QKV
projection) as long as the head and head-dim axes are packed (strides D and
1). It is one autograd Function on every device: the forward saves
q, k, v, o and lse, and the backward is ``flash_attention_bwd``.

The plain versions also take a subset of query rows as they are.
``flash_lse_plain_chunked`` and ``flash_bwd_dkdv_plain_chunked`` compute
the same math a chunk of query rows at a time, for sequences whose Sq x Sk
matrix cannot be held.

CPU tensors go to the plain versions; CUDA tensors launch the kernels or
raise. ``_design`` picks a pass's kernel entry (``ops/kernels.py``), which
counts its launches. The bf16 kernels load through TMA, which needs 16-byte
aligned bases and D and strides in multiples of 8 elements; inputs that are
not are copied first (``tma_inputs``), and the copies are counted under the
kernel's ``<name>.input_copies``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from medical_image_generation_tpu_torch.ops import kernels
from medical_image_generation_tpu_torch.ops.kernels import KERNELS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NARROW_MAX_D = 64  # padded head dims the narrow kernels take (csrc/flash_narrow.cuh)


def takes_narrow(dtype, D: int) -> bool:
    """Whether a CUDA call at head dim D launches the narrow kernels: bf16
    whose D', D padded to a multiple of 8 as ``tma_inputs`` pads it, is at
    most NARROW_MAX_D. fp32 and wider heads take the wide kernels."""
    return dtype == torch.bfloat16 and -(-D // 8) * 8 <= NARROW_MAX_D


def flash_attention_plain(q, k, v, scale: float):
    """Reference math in fp32: softmax(scale * q k^T) v, plus the row
    logsumexp. Same signature and outputs as ``flash_attention``."""
    B, S, H, D = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # B H S D
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    lse = torch.logsumexp(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), vf)
    return o.permute(0, 2, 1, 3).contiguous().to(q.dtype), lse.reshape(B * H, S)


def _bwd_scores_plain(q, k, v, do, lse, delta, scale: float):
    """fp32 (p, ds) of the backward, (B, H, Sq, Sk), from the row lse and
    delta (each (B*H, Sq)); p is recomputed from lse, as the kernels do."""
    B, Sq, H, _ = q.shape
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
                  - lse.float().reshape(B, H, Sq, 1))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    return p, scale * p * (dp - delta.float().reshape(B, H, Sq, 1))


def _bshd(t, dtype):
    return t.permute(0, 2, 1, 3).contiguous().to(dtype)


def flash_bwd_dq_plain(q, k, v, o, lse, do, scale: float):
    """Plain dQ pass in fp32: (dq in BSHD, q's dtype; delta = rowsum(dO * o),
    fp32 (B*H, Sq))."""
    B, S, H, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * H, S)
    _, ds = _bwd_scores_plain(q, k, v, do, lse, delta, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float().permute(0, 2, 1, 3))
    return _bshd(dq, q.dtype), delta


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale: float):
    """Plain dK/dV pass in fp32 from the dQ pass's delta: (dk, dv) in BSHD,
    k's shape and q's dtype."""
    p, ds = _bwd_scores_plain(q, k, v, do, lse, delta, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float().permute(0, 2, 1, 3))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float().permute(0, 2, 1, 3))
    return _bshd(dk, q.dtype), _bshd(dv, q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """Reference backward in fp32 from the forward's lse, the two plain passes
    in turn: returns (dq, dk, dv) in BSHD, q's dtype."""
    dq, delta = flash_bwd_dq_plain(q, k, v, o, lse, do, scale)
    return (dq, *flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale))


def flash_lse_plain_chunked(q, k, scale: float, chunk: int = 4096):
    """The row logsumexp of ``flash_attention_plain`` over every key, fp32
    (B*H, S), from ``chunk`` query rows at a time: the S x S logits never
    exist whole (at 262144 tokens they would take 275 GB in fp32)."""
    B, S, H, _ = q.shape
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(H):
            kf = k[b, :, h].float()
            for i in range(0, S, chunk):
                logits = (q[b, i:i + chunk, h].float() @ kf.T) * scale
                lse[b * H + h, i:i + chunk] = torch.logsumexp(logits, dim=-1)
    return lse


def _rows(lse, B: int, H: int, idx):
    """The (B*H, len(idx)) columns ``idx`` of a (B*H, S) row statistic."""
    return lse.reshape(B, H, -1)[:, :, idx].reshape(B * H, len(idx))


def flash_bwd_dkdv_plain_chunked(q, k, v, do, lse, delta, scale: float, keys,
                                 chunk: int = 4096):
    """``flash_bwd_dkdv_plain`` at the key rows ``keys`` (an index tensor):
    (dk, dv) of shape (B, len(keys), H, D) in q's dtype, summed in fp32 over
    every query, ``chunk`` query rows at a time."""
    B, S, H, D = q.shape
    ks, vs = k[:, keys], v[:, keys]
    dk = torch.zeros((B, H, len(keys), D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i in range(0, S, chunk):
        rows = torch.arange(i, min(i + chunk, S), device=q.device)
        p, ds = _bwd_scores_plain(q[:, i:i + chunk], ks, vs, do[:, i:i + chunk],
                                  _rows(lse, B, H, rows), _rows(delta, B, H, rows), scale)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, do[:, i:i + chunk].float().permute(0, 2, 1, 3))
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, q[:, i:i + chunk].float().permute(0, 2, 1, 3))
    return _bshd(dk, q.dtype), _bshd(dv, q.dtype)


def _check(q, k, v):
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or (q.shape[0], *q.shape[2:]) != (k.shape[0], *k.shape[2:])):
        raise ValueError(f"q/k/v must be BSHD with one B, H and D (and k, v one shape), got "
                         f"{q.shape}, {k.shape}, {v.shape}")
    if not (q.device == k.device == v.device) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q/k/v must share device and dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, not {q.device}")
    D = q.shape[-1]
    for t in (q, k, v):
        if t.stride(3) != 1 or (t.shape[2] > 1 and t.stride(2) != D):
            raise ValueError("flash attention needs packed head and head-dim axes "
                             f"(strides [..., {D}, 1]), got strides {t.stride()}")


def _vec_ok(D: int, itemsize: int, *tensors) -> bool:
    """16-byte vector loads: D and every row/batch stride a multiple of 16
    bytes' worth of elements, and every base pointer 16-byte aligned."""
    v = 16 // itemsize
    return D % v == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) % v == 0 and t.stride(1) % v == 0
        for t in tensors)


def tma_inputs(D: int, *tensors):
    """(tensors, D', copies) for a bf16 TMA kernel: the inputs themselves when
    ``_vec_ok`` holds, else fresh contiguous copies zero-padded to D' = D
    rounded up to 8. Zero columns add nothing to q k^T, dO v^T or the
    products, so the callers drop the outputs' extra columns."""
    if _vec_ok(D, 2, *tensors):
        return tensors, D, 0
    Dp = -(-D // 8) * 8
    copies = []
    for t in tensors:
        c = t.new_zeros((*t.shape[:-1], Dp))
        c[..., :D] = t
        copies.append(c)
    return tuple(copies), Dp, len(copies)


class _Pass(NamedTuple):
    """A flash pass's two kernels, and the C function (of ``kernels.QUERIES``)
    of the wide one's shared-memory need at (D, dtype code)."""
    wide: kernels.Kernel
    narrow: kernels.Kernel
    smem_bytes: str


_FWD = _Pass(KERNELS["flash_attn_fwd"], KERNELS["flash_attn_fwd_narrow"],
             "medimgen_flash_attn_smem_bytes")
_DQ = _Pass(KERNELS["flash_attn_bwd_dq"], KERNELS["flash_attn_bwd_dq_narrow"],
            "medimgen_flash_attn_bwd_smem_bytes")
_DKDV = _Pass(KERNELS["flash_attn_bwd_dkdv"], KERNELS["flash_attn_bwd_dkdv_narrow"],
              "medimgen_flash_attn_bwd_smem_bytes")


@functools.cache
def _check_smem(kernel: kernels.Kernel, smem_bytes: str, D: int, dt: int) -> None:
    """Raise unless a block of the wide ``kernel`` has the shared memory its
    head dim D takes (asked of the library once a kernel, D and dtype)."""
    need = kernels.query(smem_bytes)(D, dt)
    limit = kernels.query("medimgen_flash_attn_smem_limit")()
    if need > limit:
        raise ValueError(f"{kernel.symbol} at head dim {D} needs {need} bytes of shared "
                         f"memory per block, more than the {limit} a block can have")


def _design(p: _Pass, q, *inputs):
    """(kernel, inputs, D', vec) of pass p on CUDA inputs (q first): the
    narrow kernel where ``takes_narrow`` holds, else the wide one. bf16
    inputs go through ``tma_inputs`` (the copies counted under the kernel's
    name) and take 16-byte loads; fp32 ones where ``_vec_ok`` holds."""
    D = q.shape[-1]
    if takes_narrow(q.dtype, D):
        kernel = p.narrow
    else:
        kernel = p.wide
        _check_smem(kernel, p.smem_bytes, D, _DTYPES[q.dtype])
    if q.dtype != torch.bfloat16:
        return kernel, (q, *inputs), D, _vec_ok(D, 4, q, *inputs)
    inputs, Dp, copies = tma_inputs(D, q, *inputs)
    if copies:
        kernels.add(f"{kernel.name}.input_copies", copies)
    return kernel, inputs, Dp, True


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd(q, k, v, scale: float):
    """Forward on checked inputs: the plain version on the CPU, else a kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    B, Sq, H, D = q.shape
    kernel, (q, k, v), Dk, vec = _design(_FWD, q, k, v)
    o = torch.empty((B, Sq, H, Dk), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
           B, H, Sq, k.shape[1], Dk, _DTYPES[q.dtype], *_strides(q, k, v), float(scale),
           int(vec), _stream(q))
    return (o if Dk == D else o[..., :D].contiguous()), lse


def _check_bwd(q, o, lse, do):
    B, S, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o and dO must be {tuple(q.shape)} in {q.dtype}")
    if lse.shape != (B * H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 ({B * H}, {S})")


def flash_bwd_dq(q, k, v, o, lse, do, scale: float):
    """dQ pass (o, do, lse contiguous): returns (dq, delta), dq of q's shape
    and delta = rowsum(dO * o) as fp32 (B*H, Sq). The plain version on the
    CPU. In bf16 the kernel also reads o and dO with 16-byte loads, so all
    five inputs go through ``tma_inputs``."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, o, lse, do, scale)
    _check_bwd(q, o, lse, do)
    B, Sq, H, D = q.shape
    kernel, (q, k, v, o, do), Dk, vec = _design(_DQ, q, k, v, o, do)
    dq = torch.empty((B, Sq, H, Dk), dtype=q.dtype, device=q.device)
    delta = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dq.data_ptr(), B, H, Sq, k.shape[1], Dk, _DTYPES[q.dtype],
           *_strides(q, k, v), float(scale), int(vec), _stream(q))
    return (dq if Dk == D else dq[..., :D].contiguous()), delta


def flash_bwd_dkdv(q, k, v, do, lse, delta, scale: float):
    """dK/dV pass, after ``flash_bwd_dq`` wrote delta: returns (dk, dv) of
    k's shape. The plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale)
    _check_bwd(q, do, lse, do)
    if delta.shape != lse.shape or delta.dtype != torch.float32 or not delta.is_contiguous():
        raise ValueError(f"delta must be contiguous fp32 {tuple(lse.shape)}")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kernel, (q, k, v, do), Dk, vec = _design(_DKDV, q, k, v, do)
    dk = torch.empty((B, Sk, H, Dk), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Sq, Sk, Dk, _DTYPES[q.dtype],
           *_strides(q, k, v), float(scale), int(vec), _stream(q))
    if Dk != D:
        dk, dv = dk[..., :D].contiguous(), dv[..., :D].contiguous()
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) in BSHD, q's dtype: the dQ pass then the dK/dV pass
    (the kernels on CUDA, their plain versions on the CPU)."""
    _check(q, k, v)
    o, do, lse = o.contiguous(), do.to(q.dtype).contiguous(), lse.contiguous()
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, scale)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """softmax(scale q k^T) v with the flash backward; lse has no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float):
    """softmax(scale * q k^T) v over BSHD tensors; returns (o, lse)."""
    _check(q, k, v)
    return FlashAttentionFn.apply(q, k, v, float(scale))

