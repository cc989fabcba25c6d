"""Flash-attention forward: the hand-written kernel and its plain version.

Port of the TPU kernel ``_flash_forward`` (``medical_image_generation_tpu/
ops/pallas_attention.py:144-184``). The kernel is ``csrc/flash_attn_fwd.cu``;
its source note gives the design and the bound.

``flash_attention(q, k, v, scale)`` takes BSHD tensors (batch, seq, heads,
head_dim) and returns ``(o, lse)``: o in BSHD (contiguous, q's dtype) and the
fp32 row logsumexp of shape (B*H, S). q, k and v may be strided views (for
example the three thirds of a fused QKV projection) as long as the head and
head-dim axes are packed (strides D and 1).

CPU tensors go to ``flash_attention_plain``; CUDA tensors launch the kernel
or raise. ``flash_attention.launches`` counts kernel launches.
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


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one BSHD shape, got {q.shape}, {k.shape}, {v.shape}")
    if not (q.device == k.device == v.device) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q/k/v must share device and dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    D = q.shape[-1]
    for t in (q, k, v):
        if t.stride(3) != 1 or (t.shape[2] > 1 and t.stride(2) != D):
            raise ValueError("flash attention needs packed head and head-dim axes "
                             f"(strides [..., {D}, 1]), got strides {t.stride()}")


@functools.cache
def _lib():
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


def _vec_ok(D: int, itemsize: int, *tensors) -> bool:
    """16-byte vector loads: D and every row/batch stride a multiple of 16
    bytes' worth of elements, and every base pointer 16-byte aligned."""
    v = 16 // itemsize
    return D % v == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) % v == 0 and t.stride(1) % v == 0
        for t in tensors)


def flash_attention(q, k, v, scale: float):
    """softmax(scale * q k^T) v over BSHD tensors; returns (o, lse)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, not {q.device}")
    B, S, H, D = q.shape
    lib = _lib()
    dt = _DTYPES[q.dtype]
    need = lib.medimgen_flash_attn_smem_bytes(D, dt)
    if need > lib.medimgen_flash_attn_smem_limit():
        raise ValueError(f"head dim {D} needs {need} bytes of shared memory per block, "
                         f"more than the {lib.medimgen_flash_attn_smem_limit()} a block can have")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    err = lib.medimgen_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, S, D, dt,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), int(_vec_ok(D, q.element_size(), q, k, v)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attn_fwd launch")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
