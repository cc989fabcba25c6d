"""Dimension-generic building blocks (2D/3D) of the port's networks.

Port of ``medical_image_generation_tpu/models/blocks.py``. Submodules carry
the flax auto-names (``GroupNorm_0``, ``ConvND_1``, ``Dense_0``, ...) so the
weight converter maps parameter paths one to one.

Tensors are N C *spatial in channels-last memory (``channels_last_3d`` in
3D); every op used here preserves that format, and GroupNorm checks it.
Parameters of the compute layers (convs, linears) are held in
``param_dtype`` (default: the compute ``dtype``) and cast to ``dtype`` where
they are used, as flax's ``param_dtype`` / ``dtype`` pair does: training
holds fp32 masters and computes in bf16, so gradients arrive in fp32 on the
fp32 params; sampling holds bf16 weights and the cast is a no-op. GroupNorm
parameters stay fp32, as in the JAX modules. No autocast: the dtypes are
explicit, and the GroupNorm kernels check them.

Two TPU execution strategies of the JAX module are not copied, because they
compute the same math:

* the virtual-concat pair path of ``ConvND`` / ``GroupNorm`` / ``ResBlock``
  (``blocks.py:60-94``, ``:127-184``): the U-Net up path concatenates
  (``torch.cat``) and runs one ResBlock on the result;
* the subpixel / transposed-conv form of ``Upsample`` (``:294-402``): here it
  is nearest x stride followed by the 3^n conv.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_generation_tpu_torch.ops.attention import dot_product_attention
from medical_image_generation_tpu_torch.ops.groupnorm import channels_last_format, group_norm


def _per_axis(value, ndim: int):
    if isinstance(value, int):
        return (value,) * ndim
    return tuple(int(v) for v in value)


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` holding its parameters in ``param_dtype`` and computing
    in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__(in_features, out_features, dtype=param_dtype or dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return F.linear(x, _cast(self.weight, d), _cast(self.bias, d))


class ConvND(nn.Module):
    """Conv with per-axis kernel/stride/padding; the conv is the child
    ``Conv_0`` (flax ``ConvND_k/Conv_0``). Its weight is kept channels-last
    so cuDNN runs NDHWC convolutions; it is held in ``param_dtype`` and cast
    to ``dtype`` for the conv."""

    def __init__(self, in_channels: int, features: int, kernel_size=3, strides=1,
                 padding=1, spatial_dims: int = 3, use_bias: bool = True,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        conv = nn.Conv3d if spatial_dims == 3 else nn.Conv2d
        self.dtype = dtype
        self.Conv_0 = conv(
            in_channels, features, _per_axis(kernel_size, spatial_dims),
            stride=_per_axis(strides, spatial_dims), padding=_per_axis(padding, spatial_dims),
            bias=use_bias, dtype=param_dtype or dtype, device=device)
        fmt = torch.channels_last_3d if spatial_dims == 3 else torch.channels_last
        self.Conv_0.weight.data = self.Conv_0.weight.data.contiguous(memory_format=fmt)

    def forward(self, x):
        c = self.Conv_0
        y = c._conv_forward(x, _cast(c.weight, self.dtype), _cast(c.bias, self.dtype))
        # a batch of one can come back NC*spatial-contiguous; GroupNorm needs
        # channels-last (a no-op otherwise)
        return y.contiguous(memory_format=channels_last_format(y))


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics and eps 1e-6 on the two GroupNorm
    kernels; the caller picks SiLU or none per call."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6, device=None):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x, silu: bool = False):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, silu)


class ResBlock(nn.Module):
    """GN -> SiLU -> conv -> (+ temb) -> GN -> SiLU -> conv, plus a 1x1
    shortcut conv when the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int, norm_num_groups: int = 32,
                 norm_eps: float = 1e-6, spatial_dims: int = 3,
                 temb_channels: Optional[int] = None, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.GroupNorm_0 = GroupNorm(in_channels, norm_num_groups, norm_eps, device)
        self.ConvND_0 = ConvND(in_channels, out_channels, 3, 1, 1, spatial_dims, **kw)
        if temb_channels is not None:
            self.Dense_0 = Linear(temb_channels, out_channels, **kw)
        self.GroupNorm_1 = GroupNorm(out_channels, norm_num_groups, norm_eps, device)
        self.ConvND_1 = ConvND(out_channels, out_channels, 3, 1, 1, spatial_dims, **kw)
        if in_channels != out_channels:
            self.ConvND_2 = ConvND(in_channels, out_channels, 1, 1, 0, spatial_dims, **kw)

    def forward(self, x, temb=None):
        h = self.ConvND_0(self.GroupNorm_0(x, silu=True))
        if temb is not None:
            t = self.Dense_0(F.silu(temb))
            h = h + t.reshape(*t.shape, *([1] * (h.dim() - 2)))
        h = self.ConvND_1(self.GroupNorm_1(h, silu=True))
        if hasattr(self, "ConvND_2"):
            x = self.ConvND_2(x)
        return x + h


class AttentionBlock(nn.Module):
    """GroupNorm -> fused QKV projection (split q, k, v) -> attention over
    the flattened grid with scale head_dim^-0.5 -> output projection ->
    residual add."""

    def __init__(self, channels: int, num_head_channels: int = -1, norm_num_groups: int = 32,
                 norm_eps: float = 1e-6, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_heads = channels // num_head_channels if num_head_channels > 0 else 1
        self.head_dim = channels // self.num_heads
        self.GroupNorm_0 = GroupNorm(channels, norm_num_groups, norm_eps, device)
        self.Dense_0 = Linear(channels, 3 * channels, **kw)
        self.Dense_1 = Linear(channels, channels, **kw)

    def forward(self, x):
        B, C = x.shape[:2]
        spatial = x.shape[2:]
        h = self.GroupNorm_0(x)
        seq = h.permute(0, *range(2, x.dim()), 1).reshape(B, -1, C)  # (B, S, C) view
        qkv = self.Dense_0(seq)
        q, k, v = (t.unflatten(-1, (self.num_heads, self.head_dim))
                   for t in qkv.split(C, dim=-1))
        out = dot_product_attention(q, k, v).reshape(B, -1, C)
        out = self.Dense_1(out)
        out = out.reshape(B, *spatial, C).permute(0, x.dim() - 1, *range(1, x.dim() - 1))
        return x + out


class Downsample(nn.Module):
    """Strided conv with per-axis geometry."""

    def __init__(self, channels: int, stride, kernel_size, padding, spatial_dims: int = 3,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.ConvND_0 = ConvND(channels, channels, kernel_size, stride, padding, spatial_dims,
                               dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(self, x):
        return self.ConvND_0(x)


class Upsample(nn.Module):
    """Nearest-neighbour upsample by per-axis stride, then a SAME 3^n conv.

    The JAX module executes this pair as a subpixel-decomposed transposed
    conv (``upsample_subpixel``), a TPU strategy that is equal in real
    arithmetic to the two steps written here. The learned transposed-conv
    variant (``use_convtranspose``) is not ported yet."""

    def __init__(self, channels: int, stride, spatial_dims: int = 3,
                 use_convtranspose: bool = False, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        if use_convtranspose:
            raise NotImplementedError("use_convtranspose=True is not ported yet")
        self.stride = _per_axis(stride, spatial_dims)
        self.ConvND_0 = ConvND(channels, channels, 3, 1, 1, spatial_dims, dtype=dtype,
                               param_dtype=param_dtype, device=device)

    def forward(self, x):
        if any(s > 1 for s in self.stride):
            x = F.interpolate(x, scale_factor=self.stride, mode="nearest")
            x = x.contiguous(memory_format=channels_last_format(x))
        return self.ConvND_0(x)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding, fp32, laid out [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def to_internal(x):
    """(B, *spatial, C) -> N C *spatial view in channels-last memory (no
    copy when x is contiguous)."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def to_public(x):
    """N C *spatial -> (B, *spatial, C) view."""
    return x.permute(0, *range(2, x.dim()), 1)


def per_level(value, n: int) -> Sequence[int]:
    return tuple(value) if isinstance(value, (list, tuple)) else (value,) * n
