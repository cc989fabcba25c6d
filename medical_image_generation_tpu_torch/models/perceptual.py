"""Perceptual (feature-space) reconstruction loss of stage-1 training.

Port of ``medical_image_generation_tpu/models/perceptual.py`` (:27-167):
``VGGFeatures`` (the VGG16 conv plan ``_VGG_PLAN``, or a smaller
``feature_plan``, 3x3 SAME convs with ReLU, 2x2 max-pool between stages,
the relu output of each stage's last conv kept as a feature),
``_normalize_feat`` (unit channel norm), ``_expand_to_rgb``,
``PerceptualLoss._loss_2d`` (mean squared distance of the normalised
features, averaged over the stages) and the fake-3D mode, which scores
``int(size * fake_3d_ratio)`` evenly spaced 2D slices along each spatial
axis (``_slices_along``).

The features are frozen (``requires_grad=False``); the gradient flows to
``pred`` only. Their default values are random features drawn from the
port's own ``torch.Generator(seed)`` from the distribution flax's default
``nn.Conv`` initialiser gives (``lecun_normal``: a normal of variance
1 / fan_in truncated at two standard deviations, zero biases). They are not
the JAX package's numbers (its threefry draws are not reproduced); the
parity tests carry JAX's features across with ``convert.
perceptual_from_flax``. ``MEDIMGEN_VGG_WEIGHTS`` names a ``.npz`` of
converted VGG weights (``conv{s}_{i}.kernel`` in (3, 3, in, out) and
``conv{s}_{i}.bias``, the JAX package's keys) that replaces them.

The weights are held in fp32 and cast once a loss call to the compute
``dtype``; the feature math after the convs (normalisation, distance) is
fp32, as in the JAX module.
"""

from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_generation_tpu_torch.models.blocks import to_internal

# VGG16 conv plan: (features, n_convs) per stage
_VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


class VGGFeatures(nn.Module):
    """VGG16-topology 2D feature pyramid over N C H W (channels-last)
    input with 3 channels; convs named ``conv{stage}_{i}`` as the flax
    module's."""

    def __init__(self, plan: Sequence[Tuple[int, int]] = _VGG_PLAN, device=None):
        super().__init__()
        self.plan = tuple(tuple(s) for s in plan)
        fan_in = 3
        for stage, (ch, n) in enumerate(self.plan):
            for i in range(n):
                conv = nn.Conv2d(fan_in, ch, 3, padding=1, device=device)
                conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
                conv.requires_grad_(False)
                setattr(self, f"conv{stage}_{i}", conv)
                fan_in = ch

    def convs(self):
        return [(f"conv{s}_{i}", getattr(self, f"conv{s}_{i}"))
                for s, (_, n) in enumerate(self.plan) for i in range(n)]

    @torch.no_grad()
    def init_random_(self, seed: int) -> None:
        """lecun_normal weights (truncated normal, std sqrt(1 / fan_in)) and
        zero biases, drawn on the CPU from ``torch.Generator(seed)``."""
        gen = torch.Generator().manual_seed(seed)
        for _, conv in self.convs():
            std = math.sqrt(1.0 / conv.weight[0].numel()) / _TRUNC
            w = torch.empty(conv.weight.shape)
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
            conv.weight.copy_(w)
            conv.bias.zero_()

    def forward(self, x, weights):
        """Features of x (N, 3, H, W) in the weights' dtype; ``weights`` is
        [(weight, bias)] of every conv in order, cast by the caller."""
        feats, k = [], 0
        h = x.to(weights[0][0].dtype)
        for stage, (_, n) in enumerate(self.plan):
            for _ in range(n):
                h = F.relu(F.conv2d(h, *weights[k], padding=1))
                k += 1
            feats.append(h)
            if stage < len(self.plan) - 1:
                if min(h.shape[2:]) < 2:
                    # small inputs (fake-3D slice stacks) exhaust the pyramid
                    # early; pooling a size-1 axis would emit empty tensors
                    break
                h = F.max_pool2d(h, 2, 2)
        return feats


def _normalize_feat(f):
    """Unit norm over the channels (dim 1), fp32."""
    return f * torch.rsqrt(torch.sum(f ** 2, dim=1, keepdim=True) + 1e-10)


def _expand_to_rgb(x):
    """Replicate 1..N channel images (channels last) to 3 channels."""
    c = x.shape[-1]
    if c == 3:
        return x
    if c == 1:
        return x.expand(*x.shape[:-1], 3).contiguous()
    return x.mean(dim=-1, keepdim=True).expand(*x.shape[:-1], 3).contiguous()


def slice_indices(size: int, n_slices: int) -> np.ndarray:
    """``jnp.linspace(0, size - 1, n_slices).astype(int32)`` in the same
    float32 arithmetic: ``(size - 1) * (i / (n - 1))`` rounded once,
    truncated, the last index exactly ``size - 1``."""
    if n_slices == 1:
        return np.zeros(1, np.int32)
    div = np.float32(n_slices - 1)
    step = np.arange(n_slices - 1, dtype=np.float32) / div
    out = np.float32(size - 1) * step
    return np.concatenate([out, [np.float32(size - 1)]]).astype(np.int32)


class PerceptualLoss(nn.Module):
    """``loss(pred, target)`` with (B, Y, X, C) 2D or (B, Z, Y, X, C) 3D
    images in [0, 1] (fake-3D for the latter)."""

    def __init__(self, spatial_dims: int = 2, network_type: str = "vgg",
                 is_fake_3d: bool = True, fake_3d_ratio: float = 0.2, seed: int = 0,
                 dtype=torch.bfloat16, feature_plan=None, device=None):
        super().__init__()
        if network_type != "vgg":
            raise ValueError("only vgg-topology features are supported")
        self.spatial_dims = spatial_dims  # 3D inputs always take the fake-3D path, as in JAX
        self.fake_3d_ratio = fake_3d_ratio
        self.dtype = dtype
        self.plan = tuple(tuple(s) for s in feature_plan) if feature_plan else _VGG_PLAN
        self.module = VGGFeatures(self.plan, device=device)
        self.module.init_random_(seed)
        path = os.environ.get("MEDIMGEN_VGG_WEIGHTS")
        if path and os.path.exists(path):
            self.load_npz_weights(path)

    @staticmethod
    def from_config(params: dict, dtype=torch.bfloat16, device=None) -> "PerceptualLoss":
        return PerceptualLoss(
            spatial_dims=params.get("spatial_dims", 2),
            network_type=params.get("network_type", "vgg"),
            is_fake_3d=params.get("is_fake_3d", False),
            fake_3d_ratio=params.get("fake_3d_ratio", 0.2),
            dtype=dtype, feature_plan=params.get("feature_plan"), device=device)

    @torch.no_grad()
    def load_npz_weights(self, path: str) -> None:
        """Replace every conv present in the ``.npz`` (flax layout)."""
        data = np.load(path)
        for name, conv in self.module.convs():
            if f"{name}.kernel" in data:
                k = torch.from_numpy(np.asarray(data[f"{name}.kernel"], np.float32))
                conv.weight.copy_(k.permute(3, 2, 0, 1))
                conv.bias.copy_(torch.from_numpy(np.asarray(data[f"{name}.bias"], np.float32)))

    def _weights(self):
        return [(c.weight.to(self.dtype), c.bias.to(self.dtype)) for _, c in self.module.convs()]

    def _loss_2d(self, pred, target, weights):
        """Channel-normalised feature L2 per stage, averaged over stages."""
        pf = self.module(to_internal(_expand_to_rgb(pred)), weights)
        tf = self.module(to_internal(_expand_to_rgb(target)), weights)
        total = 0.0
        for a, b in zip(pf, tf):
            total = total + torch.mean((_normalize_feat(a.float()) - _normalize_feat(b.float()))
                                       ** 2)
        return total / len(pf)

    @staticmethod
    def _slices_along(x, axis: int, n_slices: int):
        """Evenly spaced slices along spatial axis ``axis`` (1..3 of
        (B, Z, Y, X, C)), folded into a 2D batch (B * n, H, W, C)."""
        idx = torch.from_numpy(slice_indices(x.shape[axis], n_slices)).to(x.device)
        taken = torch.movedim(torch.index_select(x, axis, idx), axis, 1)
        return taken.reshape(taken.shape[0] * taken.shape[1], *taken.shape[2:])

    def forward(self, pred, target):
        weights = self._weights()
        if self.spatial_dims == 2 or pred.dim() == 4:
            return self._loss_2d(pred, target, weights)
        total = 0.0
        for axis in (1, 2, 3):
            n = max(1, int(pred.shape[axis] * self.fake_3d_ratio))
            total = total + self._loss_2d(self._slices_along(pred, axis, n),
                                          self._slices_along(target, axis, n), weights)
        return total / 3.0

