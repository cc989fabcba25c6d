"""GroupNorm on channels-last activations, forward and backward: channel
statistics with the group fold, the affine(+SiLU) apply and the two backward
passes, each a hand-written kernel with its plain version beside it, joined
by one ``torch.autograd.Function`` (``group_norm``).

Port of the TPU kernels in ``medical_image_generation_tpu/ops/
pallas_groupnorm.py``:

* ``stats_fold``     <- ``lane_stats`` (:102) and ``lane_stats_any`` (:161),
  then ``_fold_affine`` (:226) with pack = 1. The fold is plain JAX glue at
  (B, C) size, which XLA fuses; eager PyTorch would launch ~11 small ops for
  it per GroupNorm, and the host's launch rate bounds the U-Net forward, so
  on the GPU it runs in the channel-stats pass's second launch.
* ``affine_act``     <- ``affine_act`` (:195)
* ``gn_bwd_stats`` + ``gn_bwd_apply`` <- the closed-form gradient of
  ``_gn_vjp_bwd`` (:372-471, plain JAX; the U-Net's ``blocks.GroupNorm`` is
  differentiated by XLA): in eager PyTorch ~12 launches per GroupNorm, so
  two kernel passes here.

The forward kernels live in ``csrc/groupnorm.cu``, the backward ones in
``csrc/groupnorm_bwd.cu``; all work on a (B, M, C) buffer, which is how an
NCDHW tensor in ``torch.channels_last_3d`` memory lies (M = Z*Y*X).
``group_norm`` views the activation that way without a copy and raises if it
is not channels-last contiguous; an incoming gradient that is not
channels-last is made so by one copy (counted in ``gn_bwd_apply.grad_copies``
of ``ops/kernels.py``'s store).

Numerics: fp32 statistics, eps inside the rsqrt, and the folded affine
applied in fp32 with one rounding at the store, as the Pallas ``affine_act``
does. The JAX module ``blocks.GroupNorm`` instead applies the folded affine
in the compute dtype; in bf16 that differs by about one bf16 rounding of the
output (tolerance stated in the tests). The backward works in fp32 from the
forward's saved channel sums and folded affine, as ``_gn_vjp_bwd`` does.

CPU tensors take the plain versions; CUDA tensors launch the kernels (the
entries ``gn_stats_fold``, ``gn_affine_act``, ``gn_bwd_stats`` and
``gn_bwd_apply`` of ``ops/kernels.py``, which count the launches) or raise.
``stats_fold``, ``gn_bwd_stats`` and ``gn_bwd_apply`` also count in
``<kernel>.vector_launches`` the launches that took 16-byte loads.
"""

from __future__ import annotations

import functools

import torch

from medical_image_generation_tpu_torch.ops import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# blocks a launch aims for per SM (256 threads each), and the fewest rows a
# thread walks (the row loads it keeps in flight): channel stats (STATS_UNROLL
# in groupnorm.cu), and the two backward passes (UNROLL and STAGES in
# groupnorm_bwd.cu)
_STATS_BLOCKS_PER_SM, _STATS_UNROLL = 4, 4
_BWD_BLOCKS_PER_SM, _BWD_UNROLL = {"stats": 2, "apply": 4}, 4
_STATS_FOLD, _AFFINE_ACT, _BWD_STATS, _BWD_APPLY = (
    kernels.KERNELS[k] for k in ("gn_stats_fold", "gn_affine_act", "gn_bwd_stats",
                                 "gn_bwd_apply"))


def _vec(t, C: int) -> bool:
    """Whether a kernel can move t 16 bytes at a time: C a multiple of 16
    bytes' worth of elements and a 16-byte aligned base."""
    return C % (16 // t.element_size()) == 0 and t.data_ptr() % 16 == 0


@functools.cache
def _row_slabs(B: int, M: int, C: int, vec_width: int, sms: int, blocks_per_sm: int,
               unroll: int):
    """(rows per block, blocks along M) of a kernel that streams (B, M, C)
    rows: the channel stats and the two backward passes.

    A block is 256 threads: ``ctv`` lanes along the row's ``C / vec_width``
    vector columns (at most 32) by ``256 // ctv`` row lanes. The grid is
    (column tiles, blocks along M, B); it aims for ``blocks_per_sm`` blocks
    per SM over the whole launch, with every thread walking at least
    ``unroll`` rows. Block i covers rows [i * rows, min((i + 1) * rows, M)),
    so the blocks cover every row once, in order."""
    cols = C // vec_width
    ctv = min(cols, 32)
    ry = 256 // ctv
    tiles = -(-cols // ctv)
    want = max(1, -(-blocks_per_sm * sms // (tiles * B)))
    nblk = max(1, min(want, M // (ry * unroll)))
    rows = -(-M // nblk)
    rows = max(ry, -(-rows // ry) * ry)  # whole row-lane sweeps
    return rows, max(1, -(-M // rows))


def _stats_slabs(B: int, M: int, C: int, vec_width: int, sms: int):
    """(rows per block, blocks along M) of the channel-stats partial pass."""
    return _row_slabs(B, M, C, vec_width, sms, _STATS_BLOCKS_PER_SM, _STATS_UNROLL)


def _bwd_slabs(pass_: str, B: int, M: int, C: int, vec_width: int, sms: int):
    """(rows per block, blocks along M) of the backward ``"stats"`` or
    ``"apply"`` pass; the stats pass writes one partial per block."""
    return _row_slabs(B, M, C, vec_width, sms, _BWD_BLOCKS_PER_SM[pass_], _BWD_UNROLL)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    _AFFINE_ACT(x2.data_ptr(), A.data_ptr(), b.data_ptr(), y.data_ptr(), B, M, C,
                _DTYPES[x2.dtype], int(silu), int(vec),
                torch.cuda.current_stream(x2.device).cuda_stream)
    return y


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


def stats_fold_plain(x2, weight, bias, num_groups: int, eps: float):
    """(stats, A, b) of ``stats_fold``: ``channel_stats_plain``, then
    ``fold_affine_plain``."""
    stats = channel_stats_plain(x2)
    A, b = fold_affine_plain(stats, weight, bias, num_groups, x2.shape[1], eps)
    return stats, A, b


def stats_fold(x2, weight, bias, num_groups: int, eps: float):
    """(stats, A, b) of a (B, M, C) activation, as ``stats_fold_plain``:
    the fp32 (B, 2, C) channel sums [sum x, sum x^2] (one read of x,
    deterministic) and the folded affine, each fp32 (B, C). On the GPU the
    three are contiguous views of one buffer."""
    _check_x(x2)
    B, M, C = x2.shape
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by {num_groups} groups")
    for t in (weight, bias):
        if t.shape != (C,) or t.device != x2.device:
            raise ValueError(f"weight/bias must be ({C},) on {x2.device}")
    if x2.device.type == "cpu":
        return stats_fold_plain(x2, weight, bias, num_groups, eps)
    vec = _vec(x2, C)
    rows, nblk = _stats_slabs(B, M, C, 16 // x2.element_size() if vec else 1,
                              _sm_count(x2.device.index or 0))
    w, bf = weight.float().contiguous(), bias.float().contiguous()
    part = torch.empty((B, nblk, 2, C), dtype=torch.float32, device=x2.device)
    out = torch.empty((4, B, C), dtype=torch.float32, device=x2.device)
    stats, A, b = out[:2].view(B, 2, C), out[2], out[3]
    _STATS_FOLD(x2.data_ptr(), w.data_ptr(), bf.data_ptr(), part.data_ptr(), stats.data_ptr(),
                A.data_ptr(), b.data_ptr(), B, M, C, num_groups, float(eps), _DTYPES[x2.dtype],
                rows, nblk, int(vec), torch.cuda.current_stream(x2.device).cuda_stream)
    kernels.add("gn_stats_fold.vector_launches", vec)
    return stats, A, b


def _check_coef(x2, *coefs):
    B, _, C = x2.shape
    for t in coefs:
        if t.dtype != torch.float32 or t.device != x2.device or t.shape[0] != B \
                or t.shape[-1] != C:
            raise ValueError(f"coefficients must be fp32 (B, ..., C) = ({B}, ..., {C}) "
                             f"on {x2.device}, got {t.dtype} {tuple(t.shape)}")


def _check_x_grad(x2, g2):
    _check_x(x2)
    if g2.shape != x2.shape or g2.dtype != x2.dtype or not g2.is_contiguous():
        raise ValueError("the gradient must be a contiguous (B, M, C) tensor of x's dtype")


def _grad_z_plain(x2, g2, A, b, silu: bool):
    """fp32 cotangent of the affine output z = x*A + b."""
    gf = g2.float()
    if not silu:
        return gf
    z = x2.float() * A[:, None, :] + b[:, None, :]
    sig = torch.sigmoid(z)
    return gf * sig * (1.0 + z * (1.0 - sig))


def gn_bwd_sums_plain(x2, g2, A, b, silu: bool):
    """Per-channel t1 = sum gz and t2 = sum gz*x over the rows, fp32 (B, C)
    each."""
    gz = _grad_z_plain(x2, g2, A, b, silu)
    return gz.sum(dim=1), (gz * x2.float()).sum(dim=1)


def gn_bwd_fold_plain(t1, t2, stats, weight, num_groups: int, eps: float, n_spatial: int):
    """The fold of ``gn_bwd_stats_plain`` from the per-channel sums of
    ``gn_bwd_sums_plain`` over ``n_spatial`` rows: (coef, dscale, dbias)."""
    B, C = t1.shape
    G, Cg = num_groups, C // num_groups
    n = float(n_spatial * Cg)
    grp = stats.reshape(B, 2, G, Cg).sum(dim=-1) / n
    mean, meansq = grp[:, 0], grp[:, 1]
    rinv = torch.rsqrt((meansq - mean.square()).clamp(min=0.0) + eps)  # (B, G)
    mean_c = mean.repeat_interleave(Cg, dim=1)
    rinv_c = rinv.repeat_interleave(Cg, dim=1)
    u2 = t2 - mean_c * t1
    w = weight.float()
    S1 = (t1 * w).reshape(B, G, Cg).sum(-1)
    S2h = (u2 * w).reshape(B, G, Cg).sum(-1) * rinv
    P = -(rinv ** 2) * S2h / n
    Q = (-rinv * S1 + mean * rinv ** 2 * S2h) / n
    coef = torch.stack([P.repeat_interleave(Cg, dim=1), Q.repeat_interleave(Cg, dim=1)], dim=1)
    return coef, (u2 * rinv_c).sum(0), t1.sum(0)


def gn_bwd_stats_plain(x2, g2, A, b, stats, weight, num_groups: int, eps: float, silu: bool):
    """Per-channel t1 = sum gz, t2 = sum gz*x folded at (B, C) size into the
    per-channel coefficients coef = [P, Q] (fp32 (B, 2, C)) of
    dx = gz*A + x*P + Q, plus dscale and dbias (fp32 (C,))."""
    t1, t2 = gn_bwd_sums_plain(x2, g2, A, b, silu)
    return gn_bwd_fold_plain(t1, t2, stats, weight, num_groups, eps, x2.shape[1])


def gn_bwd_stats(x2, g2, A, b, stats, weight, num_groups: int, eps: float, silu: bool):
    """(coef, dscale, dbias) as ``gn_bwd_stats_plain``: one read of x and g,
    deterministic fp32 sums, the fold at (B, C) size."""
    _check_x_grad(x2, g2)
    _check_coef(x2, A, b, stats)
    if x2.shape[2] % num_groups:
        raise ValueError(f"channels {x2.shape[2]} not divisible by {num_groups} groups")
    if x2.device.type == "cpu":
        return gn_bwd_stats_plain(x2, g2, A, b, stats, weight, num_groups, eps, silu)
    B, M, C = x2.shape
    vec = _vec(x2, C) and _vec(g2, C)
    rows, nblk = _bwd_slabs("stats", B, M, C, 16 // x2.element_size() if vec else 1,
                            _sm_count(x2.device.index or 0))
    w = weight.float().contiguous()
    part = torch.empty((B, nblk, 2, C), dtype=torch.float32, device=x2.device)
    coef = torch.empty((B, 2, C), dtype=torch.float32, device=x2.device)
    dscale = torch.empty((C,), dtype=torch.float32, device=x2.device)
    dbias = torch.empty_like(dscale)
    A, b, stats = A.contiguous(), b.contiguous(), stats.contiguous()
    _BWD_STATS(x2.data_ptr(), g2.data_ptr(), A.data_ptr(), b.data_ptr(), stats.data_ptr(),
               w.data_ptr(), part.data_ptr(), coef.data_ptr(), dscale.data_ptr(),
               dbias.data_ptr(), B, M, C, num_groups, float(eps), _DTYPES[x2.dtype], int(silu),
               rows, nblk, int(vec), torch.cuda.current_stream(x2.device).cuda_stream)
    kernels.add("gn_bwd_stats.vector_launches", vec)
    return coef, dscale, dbias


def gn_bwd_apply_plain(x2, g2, A, b, coef, silu: bool):
    """dx = gz*A + x*P + Q in fp32, stored in x's dtype."""
    gz = _grad_z_plain(x2, g2, A, b, silu)
    dx = gz * A[:, None, :] + x2.float() * coef[:, 0, None, :] + coef[:, 1, None, :]
    return dx.to(x2.dtype)


def gn_bwd_apply(x2, g2, A, b, coef, silu: bool):
    """dx as ``gn_bwd_apply_plain``: two reads and one write of (B, M, C)."""
    _check_x_grad(x2, g2)
    _check_coef(x2, A, b, coef)
    if x2.device.type == "cpu":
        return gn_bwd_apply_plain(x2, g2, A, b, coef, silu)
    B, M, C = x2.shape
    A, b, coef = A.contiguous(), b.contiguous(), coef.contiguous()
    dx = torch.empty_like(x2)
    vec = all(_vec(t, C) for t in (x2, g2, dx))
    rows, nblk = _bwd_slabs("apply", B, M, C, 16 // x2.element_size() if vec else 1,
                            _sm_count(x2.device.index or 0))
    _BWD_APPLY(x2.data_ptr(), g2.data_ptr(), A.data_ptr(), b.data_ptr(), coef.data_ptr(),
               dx.data_ptr(), B, M, C, _DTYPES[x2.dtype], int(silu), rows, nblk, int(vec),
               torch.cuda.current_stream(x2.device).cuda_stream)
    kernels.add("gn_bwd_apply.vector_launches", vec)
    return dx


def group_norm_bwd_plain(x2, g2, stats, weight, bias, num_groups: int, eps: float,
                         silu: bool):
    """Closed-form GroupNorm(+SiLU) gradient from the forward's fp32 (B, 2, C)
    channel sums: returns (dx in x's dtype, dscale, dbias fp32)."""
    A, b = fold_affine_plain(stats, weight, bias, num_groups, x2.shape[1], eps)
    coef, dscale, dbias = gn_bwd_stats_plain(x2, g2, A, b, stats, weight, num_groups, eps,
                                             silu)
    return gn_bwd_apply_plain(x2, g2, A, b, coef, silu), dscale, dbias


def channels_last_format(x):
    return torch.channels_last_3d if x.dim() == 5 else torch.channels_last


def _to_rows(x):
    """N C *spatial -> (B, M, C) view (channels-last memory) and the permuted
    shape to come back from."""
    perm = (0, *range(2, x.dim()), 1)
    xp = x.permute(perm)
    return xp, xp.reshape(x.shape[0], -1, x.shape[1])


def _from_rows(y2, shape_p):
    yp = y2.reshape(shape_p)
    return yp.permute(0, yp.dim() - 1, *range(1, yp.dim() - 1))


class GroupNormFn(torch.autograd.Function):
    """GroupNorm(+SiLU): stats and fold -> affine forward, the two backward
    kernels (or their plain versions) for the gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        xp, x2 = _to_rows(x)
        stats, A, b = stats_fold(x2, weight, bias, num_groups, eps)
        y2 = affine_act(x2, A, b, silu)
        ctx.save_for_backward(x, stats, A, b, weight)
        ctx.cfg = (num_groups, eps, silu)
        return _from_rows(y2, xp.shape)

    @staticmethod
    def backward(ctx, gy):
        x, stats, A, b, weight = ctx.saved_tensors
        num_groups, eps, silu = ctx.cfg
        xp, x2 = _to_rows(x)
        gp = gy.to(x.dtype).permute(0, *range(2, gy.dim()), 1)
        if not gp.is_contiguous():
            gp = gp.contiguous()
            kernels.add("gn_bwd_apply.grad_copies")
        g2 = gp.reshape(x2.shape)
        coef, dscale, dbias = gn_bwd_stats(x2, g2, A, b, stats, weight, num_groups, eps, silu)
        dx = gn_bwd_apply(x2, g2, A, b, coef, silu) if ctx.needs_input_grad[0] else None
        return (None if dx is None else _from_rows(dx, xp.shape),
                dscale.to(weight.dtype), dbias.to(weight.dtype), None, None, None)


def group_norm(x, weight, bias, num_groups: int, eps: float = 1e-6, silu: bool = False):
    """GroupNorm (+ optional SiLU) of an N C *spatial tensor held in
    channels-last memory; returns a tensor of the same shape, dtype and
    memory format."""
    C = x.shape[1]
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by {num_groups} groups")
    if x.dim() > 3 and not x.is_contiguous(memory_format=channels_last_format(x)):
        raise ValueError("group_norm expects a channels-last activation "
                         f"(strides {x.stride()} for shape {tuple(x.shape)})")
    return GroupNormFn.apply(x, weight, bias, num_groups, float(eps), bool(silu))
