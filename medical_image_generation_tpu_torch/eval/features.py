"""Feature extractors of the generative eval's FID (2D and 3D ResNet50).

Port of ``medical_image_generation_tpu/eval/features.py`` (:38-207), with
the flax module names (``ConvND_0``, ``_Bottleneck_k``, ``GroupNorm_k``,
``FrozenBatchNorm_k``), so ``convert.features_from_flax`` maps a JAX
extractor's tree one to one:

* random-feature mode (the default): ResNet50-topology bottlenecks with a
  per-channel instance norm after the first two convs of each (flax
  ``GroupNorm(group_size=1)``, eps 1e-6), which runs on the port's
  GroupNorm kernels as ``blocks.GroupNorm`` with one channel a group; bf16
  compute. FID over fixed random features is a relative metric, comparable
  across the checkpoints of one run;
* pretrained mode, when ``MEDIMGEN_FID_WEIGHTS_{2D,3D}`` names an ``.npz``
  (the file the JAX package reads: flax paths ``params/ConvND_0/Conv_0/
  kernel`` ...): the reference networks' inference architecture, a frozen
  BatchNorm affine after every conv and bias-free convs, with MedicalNet's
  dilated layer3 / layer4 in 3D; fp32 compute.

The random weights are drawn on the CPU from ``torch.Generator(seed)``
with the distributions of flax's default initialisers (convs
``lecun_normal``: a normal of variance 1 / fan_in truncated at two standard
deviations, zero biases; norms scale 1, bias 0). They are not the JAX
package's numbers (its threefry draws are not reproduced); the parity tests
carry a JAX tree across with ``convert.features_from_flax``.

``FeatureExtractor(images)`` takes (N, *spatial, C) images in [0, 1] (numpy
or a tensor), preprocesses them as the reference does (2D: gray to three
channels, BGR, mean subtraction; 3D: per-volume z-score), and returns
(N, 2048) fp32 numpy features.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_generation_tpu_torch._device import resolve_device
from medical_image_generation_tpu_torch.models.blocks import (
    ConvND,
    GroupNorm,
    to_internal,
)
from medical_image_generation_tpu_torch.ops.groupnorm import channels_last_format

# (features, blocks, stride, dilation) per ResNet50 stage.
# torchvision / RadImageNet: strides (1, 2, 2, 2), no dilation.
# MedicalNet (3D segmentation backbone, shortcut 'B'): layer3/4 keep
# stride 1 and dilate 2 / 4 instead.
RESNET50_STAGES = ((64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 2, 1), (512, 3, 2, 1))
MEDICALNET_STAGES = ((64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 1, 2), (512, 3, 1, 4))
_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
_BGR_MEAN = (0.406, 0.456, 0.485)


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm: y = x * mul + add with mul = scale /
    sqrt(var + eps), add = bias - mean * mul folded in fp32 and applied in
    the compute dtype (torch BN eval semantics)."""

    def __init__(self, features: int, epsilon: float = 1e-5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.mean = nn.Parameter(torch.zeros(features, device=device))
        self.var = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x):
        mul = self.weight * torch.rsqrt(self.var + self.epsilon)
        add = self.bias - self.mean * mul
        shape = (1, -1) + (1,) * (x.dim() - 2)
        d = self.dtype
        return x.to(d) * mul.to(d).reshape(shape) + add.to(d).reshape(shape)


class _Bottleneck(nn.Module):
    """ResNet50 bottleneck. ``frozen_bn=False`` (random-feature mode) uses a
    per-channel instance norm after the first two convs; ``frozen_bn=True``
    is the torchvision block (a frozen BN after every conv, the projection
    shortcut's too)."""

    def __init__(self, in_features: int, features: int, stride: int = 1, dilation: int = 1,
                 spatial_dims: int = 2, frozen_bn: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        sd, bias = spatial_dims, not frozen_bn
        kw = dict(dtype=dtype, device=device)
        self.frozen_bn = frozen_bn
        self.ConvND_0 = ConvND(in_features, features, 1, 1, 0, sd, use_bias=bias, **kw)
        self.ConvND_1 = ConvND(features, features, 3, stride, dilation, sd, use_bias=bias,
                               kernel_dilation=dilation, **kw)
        self.ConvND_2 = ConvND(features, features * 4, 1, 1, 0, sd, use_bias=bias, **kw)
        self.project = in_features != features * 4 or stride != 1
        if self.project:
            self.ConvND_3 = ConvND(in_features, features * 4, 1, stride, 0, sd, use_bias=bias,
                                   **kw)
        if frozen_bn:
            for i, ch in enumerate((features, features, features * 4, features * 4)[
                    :4 if self.project else 3]):
                setattr(self, f"FrozenBatchNorm_{i}", FrozenBatchNorm(ch, dtype=dtype,
                                                                      device=device))
        else:
            self.GroupNorm_0 = GroupNorm(features, features, 1e-6, device)
            self.GroupNorm_1 = GroupNorm(features, features, 1e-6, device)

    def _norm(self, h, i: int):
        if self.frozen_bn:
            return getattr(self, f"FrozenBatchNorm_{i}")(h)
        return getattr(self, f"GroupNorm_{i}")(h)

    def forward(self, x):
        h = F.relu(self._norm(self.ConvND_0(x), 0))
        h = F.relu(self._norm(self.ConvND_1(h), 1))
        h = self.ConvND_2(h)
        if self.frozen_bn:
            h = self._norm(h, 2)
        residual = x
        if self.project:
            residual = self.ConvND_3(x)
            if self.frozen_bn:
                residual = self._norm(residual, 3)
        return F.relu(h + residual)


class ResNet50Features(nn.Module):
    """ResNet50-topology global-pooled features (2048-d) of (B, *spatial, C)
    channels-last images. ``stages`` selects the torchvision (RadImageNet)
    or MedicalNet geometry; ``frozen_bn`` the pretrained-exact
    normalisation."""

    def __init__(self, spatial_dims: int = 2, stages: Sequence[Tuple[int, ...]] = RESNET50_STAGES,
                 frozen_bn: bool = False, in_channels: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        sd = spatial_dims
        self.spatial_dims, self.frozen_bn, self.dtype = sd, frozen_bn, dtype
        in_channels = in_channels or (3 if sd == 2 else 1)
        self.ConvND_0 = ConvND(in_channels, 64, 7, 2, 3, sd, use_bias=not frozen_bn,
                               dtype=dtype, device=device)
        if frozen_bn:
            self.FrozenBatchNorm_0 = FrozenBatchNorm(64, dtype=dtype, device=device)
        k, ch = 0, 64
        for features, blocks, stride, dilation in stages:
            for i in range(blocks):
                setattr(self, f"_Bottleneck_{k}", _Bottleneck(
                    ch, features, stride if i == 0 else 1, dilation, sd, frozen_bn, dtype,
                    device))
                ch, k = features * 4, k + 1
        self.n_blocks = k

    def forward(self, x):
        sd = self.spatial_dims
        h = self.ConvND_0(to_internal(x).to(self.dtype))
        if self.frozen_bn:
            h = self.FrozenBatchNorm_0(h)
        h = F.relu(h)
        pool = F.max_pool3d if sd == 3 else F.max_pool2d
        h = pool(h, 3, 2, 1)
        h = h.contiguous(memory_format=channels_last_format(h))
        for k in range(self.n_blocks):
            h = getattr(self, f"_Bottleneck_{k}")(h)
        return torch.mean(h, dim=tuple(range(2, h.dim()))).float()

    @torch.no_grad()
    def init_random_(self, seed: int) -> None:
        """flax's default initialisers, drawn on the CPU from
        ``torch.Generator(seed)``: conv weights lecun_normal, biases 0,
        norms scale 1 / bias 0 (frozen BN: mean 0, var 1)."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (GroupNorm, FrozenBatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, FrozenBatchNorm):
                    m.mean.zero_()
                    m.var.fill_(1.0)


def load_npz(path: str) -> dict:
    """A flat ``.npz`` of flax paths (``params/ConvND_0/Conv_0/kernel``) as a
    nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(data[key])
    return tree


class FeatureExtractor:
    """Frozen feature extractor with optional pretrained weights.

    Without weights: deterministic random features (instance-norm blocks,
    bf16). With ``MEDIMGEN_FID_WEIGHTS_{2D,3D}`` naming an existing file:
    the reference protocol's network, the frozen-BN ResNet50 (2D /
    RadImageNet) or MedicalNet's dilated variant (3D), fp32."""

    def __init__(self, spatial_dims: int = 2, seed: int = 0, dtype=None,
                 device: str | torch.device = "cuda"):
        self.spatial_dims = spatial_dims
        self.device = resolve_device(device)
        path = os.environ.get(f"MEDIMGEN_FID_WEIGHTS_{spatial_dims}D")
        self.pretrained = bool(path and os.path.exists(path))
        if dtype is None:
            # pretrained mode matches the reference's fp32 inference;
            # random-feature mode only needs relative comparisons -> bf16
            dtype = torch.float32 if self.pretrained else torch.bfloat16
        self.dtype = dtype
        stages = MEDICALNET_STAGES if self.pretrained and spatial_dims == 3 else RESNET50_STAGES
        self.module = ResNet50Features(spatial_dims, stages, self.pretrained, dtype=dtype,
                                       device=self.device)
        self.module.init_random_(seed)
        if self.pretrained:
            self.load_flax(load_npz(path), path)
        self.module.eval().requires_grad_(False)

    def load_flax(self, tree, source: str = "the tree") -> None:
        """Load a flax ``ResNet50Features`` tree (with or without the outer
        ``params``); every array of the module must be there."""
        from medical_image_generation_tpu_torch import convert

        sd = convert.features_from_flax(tree)
        want = self.module.state_dict()
        missing = [k for k in want if k not in sd]
        if missing:
            raise ValueError(f"{source} is missing {len(missing)} arrays (e.g. {missing[:3]}); "
                             "convert with tools/convert_torch_weights.py resnet50")
        self.module.load_state_dict({k: sd[k] for k in want})

    def preprocess_2d(self, images: torch.Tensor) -> torch.Tensor:
        """RadImageNet-style: grayscale -> 3 channels, BGR order, mean
        subtraction; multi-channel inputs other than 3 collapse to gray
        first."""
        if images.shape[-1] == 1:
            images = images.expand(*images.shape[:-1], 3)
        elif images.shape[-1] != 3:
            images = images.mean(dim=-1, keepdim=True).expand(*images.shape[:-1], 3)
        images = torch.flip(images, dims=(-1,))  # RGB -> BGR
        return images - torch.tensor(_BGR_MEAN, dtype=images.dtype, device=images.device)

    def preprocess_3d(self, images: torch.Tensor) -> torch.Tensor:
        """MedicalNet-style per-volume z-score; C > 1 volumes collapse to one
        channel."""
        if images.shape[-1] != 1:
            images = images.mean(dim=-1, keepdim=True)
        axes = tuple(range(1, images.dim()))
        mean = images.mean(dim=axes, keepdim=True)
        std = images.std(dim=axes, keepdim=True, correction=0) + 1e-7
        return (images - mean) / std

    @torch.no_grad()
    def __call__(self, images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32) if not isinstance(
            images, torch.Tensor) else images).to(self.device, torch.float32)
        x = self.preprocess_2d(x) if self.spatial_dims == 2 else self.preprocess_3d(x)
        return self.module(x.contiguous()).cpu().numpy()
