"""Flash attention, forward and backward: the hand-written kernels, their
plain versions, and the ``torch.autograd.Function`` that joins them.

Ports of the TPU kernels ``_flash_forward`` (``medical_image_generation_tpu/
ops/pallas_attention.py:144-184``) and ``_flash_backward`` (``:310-358``).
The kernels are ``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``;
their source notes give the designs and the bounds.

``flash_attention(q, k, v, scale)`` takes BSHD tensors (batch, seq, heads,
head_dim) and returns ``(o, lse)``: o in BSHD (contiguous, q's dtype) and the
fp32 row logsumexp of shape (B*H, S), which carries no gradient. q, k and v
may be strided views (for example the three thirds of a fused QKV
projection) as long as the head and head-dim axes are packed (strides D and
1). It is one autograd Function on every device: the forward saves
q, k, v, o and lse, and the backward is ``flash_attention_bwd``.

CPU tensors go to the plain versions; CUDA tensors launch the kernels or
raise. Launch counters: ``flash_attention.launches`` (forward),
``flash_bwd_dq.launches`` and ``flash_bwd_dkdv.launches`` (the two backward
passes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from medical_image_generation_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    fp32 (B*H, S))."""
    B, S, H, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * H, S)
    _, ds = _bwd_scores_plain(q, k, v, do, lse, delta, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float().permute(0, 2, 1, 3))
    return _bshd(dq, q.dtype), delta


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale: float):
    """Plain dK/dV pass in fp32 from the dQ pass's delta: (dk, dv) in BSHD,
    q's dtype."""
    p, ds = _bwd_scores_plain(q, k, v, do, lse, delta, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float().permute(0, 2, 1, 3))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float().permute(0, 2, 1, 3))
    return _bshd(dk, q.dtype), _bshd(dv, q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """Reference backward in fp32 from the forward's lse, the two plain passes
    in turn: returns (dq, dk, dv) in BSHD, q's dtype."""
    dq, delta = flash_bwd_dq_plain(q, k, v, o, lse, do, scale)
    return (dq, *flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale))


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one BSHD shape, got {q.shape}, {k.shape}, {v.shape}")
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


@functools.cache
def _lib_fwd():
    lib = _build.load("flash_attn_fwd")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.medimgen_flash_attn_fwd.argtypes = (
        [vp] * 5 + [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, vp])
    lib.medimgen_flash_attn_fwd.restype = i32
    lib.medimgen_flash_attn_smem_bytes.argtypes = [i32, i32]
    lib.medimgen_flash_attn_smem_bytes.restype = i64
    lib.medimgen_flash_attn_smem_limit.argtypes = []
    lib.medimgen_flash_attn_smem_limit.restype = i64
    return lib


@functools.cache
def _lib_bwd():
    lib = _build.load("flash_attn_bwd")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.medimgen_flash_attn_bwd_dq.argtypes = (
        [vp] * 8 + [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, vp])
    lib.medimgen_flash_attn_bwd_dq.restype = i32
    lib.medimgen_flash_attn_bwd_dkdv.argtypes = (
        [vp] * 8 + [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, vp])
    lib.medimgen_flash_attn_bwd_dkdv.restype = i32
    lib.medimgen_flash_attn_bwd_smem_bytes.argtypes = [i32, i32]
    lib.medimgen_flash_attn_bwd_smem_bytes.restype = i64
    return lib


def _vec_ok(D: int, itemsize: int, *tensors) -> bool:
    """16-byte vector loads: D and every row/batch stride a multiple of 16
    bytes' worth of elements, and every base pointer 16-byte aligned."""
    v = 16 // itemsize
    return D % v == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) % v == 0 and t.stride(1) % v == 0
        for t in tensors)


def _check_smem(need: int, D: int, what: str):
    limit = _lib_fwd().medimgen_flash_attn_smem_limit()
    if need > limit:
        raise ValueError(f"{what} at head dim {D} needs {need} bytes of shared memory per "
                         f"block, more than the {limit} a block can have")


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))


def _fwd(q, k, v, scale: float):
    """Forward on checked inputs: the plain version on the CPU, else the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    B, S, H, D = q.shape
    lib = _lib_fwd()
    dt = _DTYPES[q.dtype]
    _check_smem(lib.medimgen_flash_attn_smem_bytes(D, dt), D, "the flash forward")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    err = lib.medimgen_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, S, D, dt, *_strides(q, k, v),
        float(scale), int(_vec_ok(D, q.element_size(), q, k, v)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attn_fwd launch")
    flash_attention.launches += 1
    return o, lse


def _bwd_args(q, k, v, o, lse, do):
    B, S, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o and dO must be {tuple(q.shape)} in {q.dtype}")
    if lse.shape != (B * H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 ({B * H}, {S})")
    lib = _lib_bwd()
    dt = _DTYPES[q.dtype]
    _check_smem(lib.medimgen_flash_attn_bwd_smem_bytes(D, dt), D, "the flash backward")
    vec = _vec_ok(D, q.element_size(), q, k, v, o, do)
    return lib, dt, vec, torch.cuda.current_stream(q.device).cuda_stream


def flash_bwd_dq(q, k, v, o, lse, do, scale: float):
    """dQ pass (o, do, lse contiguous): returns (dq, delta), delta =
    rowsum(dO * o) as fp32 (B*H, S). The plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, o, lse, do, scale)
    B, S, H, D = q.shape
    lib, dt, vec, stream = _bwd_args(q, k, v, o, lse, do)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    err = lib.medimgen_flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, H, S, D, dt, *_strides(q, k, v), float(scale),
        int(vec), stream)
    _build.check(err, "flash_attn_bwd dq launch")
    flash_bwd_dq.launches += 1
    return dq, delta


def flash_bwd_dkdv(q, k, v, do, lse, delta, scale: float):
    """dK/dV pass, after ``flash_bwd_dq`` wrote delta: returns (dk, dv).
    The plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, scale)
    B, S, H, D = q.shape
    lib, dt, vec, stream = _bwd_args(q, k, v, do, lse, do)
    if delta.shape != lse.shape or delta.dtype != torch.float32 or not delta.is_contiguous():
        raise ValueError(f"delta must be contiguous fp32 {tuple(lse.shape)}")
    dk = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = lib.medimgen_flash_attn_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, S, D, dt, *_strides(q, k, v),
        float(scale), int(vec), stream)
    _build.check(err, "flash_attn_bwd dkdv launch")
    flash_bwd_dkdv.launches += 1
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


flash_attention.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkdv.launches = 0
