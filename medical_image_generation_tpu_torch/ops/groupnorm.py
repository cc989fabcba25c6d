"""GroupNorm on channels-last activations: channel statistics, the group
fold and the affine(+SiLU) apply, each a hand-written kernel with its plain
version beside it.

Port of the TPU kernels in ``medical_image_generation_tpu/ops/
pallas_groupnorm.py``:

* ``channel_stats``  <- ``lane_stats`` (:102) and ``lane_stats_any`` (:161)
* ``affine_act``     <- ``affine_act`` (:195)
* ``fold_affine``    <- ``_fold_affine`` (:226) with pack = 1: plain JAX
  glue at (B, C) size, which XLA fuses; eager PyTorch would launch ~11 small
  ops for it per GroupNorm, and the host's launch rate bounds the U-Net
  forward, so on the GPU it is one small kernel too.

The kernels live in ``csrc/groupnorm.cu``; stats and affine work on a (B, M, C) buffer,
which is how an NCDHW tensor in ``torch.channels_last_3d`` memory lies
(M = Z*Y*X). ``group_norm`` views the activation that way without a copy and
raises if it is not channels-last contiguous.

Numerics: fp32 statistics, eps inside the rsqrt, and the folded affine
applied in fp32 with one rounding at the store, as the Pallas ``affine_act``
does. The JAX module ``blocks.GroupNorm`` instead applies the folded affine
in the compute dtype; in bf16 that differs by about one bf16 rounding of the
output (tolerance stated in the tests).

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. ``channel_stats.launches`` / ``fold_affine.launches`` /
``affine_act.launches`` count launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from medical_image_generation_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# rows of M each stats block reduces: at least 128, and at most ~1024 blocks
# along M so the fixed-order second pass stays short
_MIN_ROWS, _MAX_BLOCKS = 128, 1024


@functools.cache
def _lib():
    lib = _build.load("groupnorm")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.medimgen_gn_channel_stats.argtypes = [vp, vp, vp, i32, i64, i32, i32, i64, i32, vp]
    lib.medimgen_gn_channel_stats.restype = i32
    lib.medimgen_gn_affine_act.argtypes = [vp, vp, vp, vp, i32, i64, i32, i32, i32, i32, vp]
    lib.medimgen_gn_affine_act.restype = i32
    lib.medimgen_gn_fold.argtypes = [vp] * 5 + [i32, i32, i32, i64, ctypes.c_float, vp]
    lib.medimgen_gn_fold.restype = i32
    return lib


def _check_x(x2):
    if x2.dim() != 3 or not x2.is_contiguous():
        raise ValueError(f"expected a contiguous (B, M, C) activation, got {tuple(x2.shape)} "
                         f"with strides {x2.stride()}")
    if x2.dtype not in _DTYPES:
        raise TypeError(f"GroupNorm kernels take float32 or bfloat16, got {x2.dtype}")
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"GroupNorm kernels run on CUDA or CPU tensors, not {x2.device}")


def channel_stats_plain(x2):
    """(B, M, C) -> fp32 (B, 2, C): per-channel [sum x, sum x^2]."""
    xf = x2.float()
    return torch.stack([xf.sum(dim=1), xf.square().sum(dim=1)], dim=1)


def channel_stats(x2):
    """(B, M, C) -> fp32 (B, 2, C): per-channel [sum x, sum x^2], one read
    of the activation, deterministic."""
    _check_x(x2)
    if x2.device.type == "cpu":
        return channel_stats_plain(x2)
    B, M, C = x2.shape
    rows = max(_MIN_ROWS, -(-M // _MAX_BLOCKS))
    nblk = -(-M // rows)
    part = torch.empty((B, nblk, 2, C), dtype=torch.float32, device=x2.device)
    out = torch.empty((B, 2, C), dtype=torch.float32, device=x2.device)
    err = _lib().medimgen_gn_channel_stats(
        x2.data_ptr(), part.data_ptr(), out.data_ptr(), B, M, C, _DTYPES[x2.dtype], rows, nblk,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "gn channel_stats launch")
    channel_stats.launches += 1
    return out


channel_stats.launches = 0


def affine_act_plain(x2, A, b, silu: bool):
    """y = act(x * A + b) in fp32, stored in x's dtype; A, b: fp32 (B, C)."""
    y = x2.float() * A[:, None, :] + b[:, None, :]
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(x2.dtype)


def affine_act(x2, A, b, silu: bool):
    """y = act(x * A + b), fp32 math, one read and one write of (B, M, C)."""
    _check_x(x2)
    B, M, C = x2.shape
    for t in (A, b):
        if t.shape != (B, C) or t.dtype != torch.float32 or t.device != x2.device:
            raise ValueError(f"A/b must be fp32 (B, C) = ({B}, {C}) on {x2.device}")
    if x2.device.type == "cpu":
        return affine_act_plain(x2, A, b, silu)
    A, b = A.contiguous(), b.contiguous()
    y = torch.empty_like(x2)
    vec = C % (16 // x2.element_size()) == 0 and x2.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    err = _lib().medimgen_gn_affine_act(
        x2.data_ptr(), A.data_ptr(), b.data_ptr(), y.data_ptr(), B, M, C, _DTYPES[x2.dtype],
        int(silu), int(vec), torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "gn affine_act launch")
    affine_act.launches += 1
    return y


affine_act.launches = 0


def fold_affine_plain(stats, weight, bias, num_groups: int, n_spatial: int, eps: float):
    """Group statistics and the folded per-(batch, channel) affine from the
    fp32 (B, 2, C) channel sums, all at (B, C) size:

        A = weight * rsqrt(var + eps),  b = bias - mean * A
    """
    B, _, C = stats.shape
    G = num_groups
    cnt = float(n_spatial * (C // G))
    grp = stats.reshape(B, 2, G, C // G).sum(dim=-1) / cnt  # (B, 2, G)
    mean, meansq = grp[:, 0], grp[:, 1]
    rinv = torch.rsqrt((meansq - mean.square()).clamp(min=0.0) + eps)
    A = rinv[:, :, None] * weight.float().reshape(G, C // G)[None]
    bb = bias.float().reshape(G, C // G)[None] - mean[:, :, None] * A
    return A.reshape(B, C), bb.reshape(B, C)


def fold_affine(stats, weight, bias, num_groups: int, n_spatial: int, eps: float):
    """(A, b), each fp32 (B, C), from the (B, 2, C) channel sums of
    ``channel_stats``; same signature as ``fold_affine_plain``."""
    B, two, C = stats.shape
    if two != 2 or stats.dtype != torch.float32 or C % num_groups:
        raise ValueError(f"expected fp32 (B, 2, C) sums with C divisible by {num_groups}")
    if stats.device.type == "cpu":
        return fold_affine_plain(stats, weight, bias, num_groups, n_spatial, eps)
    if stats.device.type != "cuda":
        raise ValueError(f"fold_affine runs on CUDA or CPU tensors, not {stats.device}")
    stats = stats.contiguous()
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    for t in (w, b):
        if t.shape != (C,) or t.device != stats.device:
            raise ValueError(f"weight/bias must be ({C},) on {stats.device}")
    A = torch.empty((B, C), dtype=torch.float32, device=stats.device)
    bb = torch.empty_like(A)
    err = _lib().medimgen_gn_fold(
        stats.data_ptr(), w.data_ptr(), b.data_ptr(), A.data_ptr(), bb.data_ptr(),
        B, C, num_groups, n_spatial, eps, torch.cuda.current_stream(stats.device).cuda_stream)
    _build.check(err, "gn fold launch")
    fold_affine.launches += 1
    return A, bb


fold_affine.launches = 0


def channels_last_format(x):
    return torch.channels_last_3d if x.dim() == 5 else torch.channels_last


def group_norm(x, weight, bias, num_groups: int, eps: float = 1e-6, silu: bool = False):
    """GroupNorm (+ optional SiLU) of an N C *spatial tensor held in
    channels-last memory; returns a tensor of the same shape, dtype and
    memory format."""
    B, C = x.shape[:2]
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by {num_groups} groups")
    if x.dim() > 3 and not x.is_contiguous(memory_format=channels_last_format(x)):
        raise ValueError("group_norm expects a channels-last activation "
                         f"(strides {x.stride()} for shape {tuple(x.shape)})")
    perm = (0, *range(2, x.dim()), 1)
    x2 = x.permute(perm).reshape(B, -1, C)  # a view: (B, M, C)
    A, bb = fold_affine(channel_stats(x2), weight, bias, num_groups, x2.shape[1], eps)
    y2 = affine_act(x2, A, bb, silu)
    inv = (0, x.dim() - 1, *range(1, x.dim() - 1))
    return y2.reshape(x.permute(perm).shape).permute(inv)
