"""Strided diffusion U-Net (2D/3D); trained through autograd (the
GroupNorm and attention kernels are autograd Functions).

Port of ``DiffusionUNet`` (``medical_image_generation_tpu/models/
diffusion_unet.py:109-285``): fp32 time MLP, optional class embedding,
down path collecting skips, mid block (ResBlock, attention, ResBlock), up
path with skip concatenation, and GN -> SiLU -> conv to an fp32 output.
Submodule names follow the flax tree (``Dense_0``, ``Embed_0``,
``ConvND_0``, ``ResBlock_i``, ``AttentionBlock_k``, ``Downsample_k``,
``Upsample_k``, ``GroupNorm_0``, ``ConvND_1``).

``use_checkpointing`` (JAX :133, :156, :178, ``nn.remat(ResBlock)``)
rematerialises every ResBlock in the backward pass: each runs under a
non-reentrant ``torch.utils.checkpoint`` with no policy
(``autoencoder_kl.remat_call`` with ``"full"``), so only the block's inputs
are kept across the forward and its GroupNorm forward kernels run again in
the backward. Attention blocks are not rematerialised, as in JAX. The flag
changes no parameter name and no result; under ``no_grad`` (sampling) it
does nothing.

Not ported yet: cross-attention conditioning (``SpatialTransformer``),
ControlNet residual injection, and ``DiffusionEncoder``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_generation_tpu_torch.models.autoencoder_kl import remat_call
from medical_image_generation_tpu_torch.models.blocks import (
    AttentionBlock,
    ConvND,
    Downsample,
    GroupNorm,
    ResBlock,
    Upsample,
    per_level,
    timestep_embedding,
    to_internal,
    to_public,
)


class DiffusionUNet(nn.Module):
    """``forward(x, timesteps, class_labels=None)`` with x in (B, *spatial,
    C_in) returns the fp32 prediction in (B, *spatial, C_out). Build from the
    planner's ddpm_params with ``from_config``. ``param_dtype`` (default:
    ``dtype``) holds the conv / linear weights: fp32 for training with bf16
    compute."""

    def __init__(self, spatial_dims=3, in_channels=8, out_channels=8,
                 num_channels=(256, 512, 768), attention_levels=(False, True, True),
                 num_head_channels=(0, 512, 768), num_res_blocks=2, norm_num_groups=32,
                 strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
                 kernel_sizes=((3, 3, 3),) * 3, paddings=((1, 1, 1),) * 3,
                 num_class_embeds: Optional[int] = None, use_checkpointing: bool = False,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        n = len(num_channels)
        nrb = per_level(num_res_blocks, n)
        self.dtype = dtype
        self.num_channels = tuple(num_channels)
        self.attention_levels = tuple(attention_levels)
        self.nrb = nrb
        self.remat = "full" if use_checkpointing else None  # remat_call's policy
        sd, G = spatial_dims, norm_num_groups
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        ted = num_channels[0] * 4
        self.Dense_0 = nn.Linear(num_channels[0], ted, device=device)  # fp32 time MLP
        self.Dense_1 = nn.Linear(ted, ted, device=device)
        if num_class_embeds is not None:
            self.Embed_0 = nn.Embedding(num_class_embeds, ted, device=device)
        self.ConvND_0 = ConvND(in_channels, num_channels[0], kernel_sizes[0], strides[0],
                               paddings[0], sd, **kw)

        def attn(level, ch):
            hc = num_head_channels[level]
            return AttentionBlock(ch, hc if hc > 0 else -1, G, **kw)

        rb, ab = 0, 0
        ch_in = num_channels[0]
        skip_ch = [ch_in]
        for level, ch in enumerate(num_channels):
            for _ in range(nrb[level]):
                setattr(self, f"ResBlock_{rb}", ResBlock(ch_in, ch, G, 1e-6, sd, ted, **kw))
                rb += 1
                ch_in = ch
                if attention_levels[level]:
                    setattr(self, f"AttentionBlock_{ab}", attn(level, ch))
                    ab += 1
                skip_ch.append(ch)
            if level != n - 1:
                setattr(self, f"Downsample_{level}",
                        Downsample(ch, strides[level + 1], kernel_sizes[level + 1],
                                   paddings[level + 1], sd, **kw))
                skip_ch.append(ch)
        ch = num_channels[-1]
        setattr(self, f"ResBlock_{rb}", ResBlock(ch, ch, G, 1e-6, sd, ted, **kw))
        setattr(self, f"AttentionBlock_{ab}", attn(n - 1, ch))
        setattr(self, f"ResBlock_{rb + 1}", ResBlock(ch, ch, G, 1e-6, sd, ted, **kw))
        rb, ab = rb + 2, ab + 1
        for i, level in enumerate(reversed(range(n))):
            ch = num_channels[level]
            for _ in range(nrb[level] + 1):
                setattr(self, f"ResBlock_{rb}",
                        ResBlock(ch_in + skip_ch.pop(), ch, G, 1e-6, sd, ted, **kw))
                rb += 1
                ch_in = ch
                if attention_levels[level]:
                    setattr(self, f"AttentionBlock_{ab}", attn(level, ch))
                    ab += 1
            if level != 0:
                setattr(self, f"Upsample_{i}", Upsample(ch, strides[level], sd, **kw))
        self.GroupNorm_0 = GroupNorm(num_channels[0], G, 1e-6, device)
        self.ConvND_1 = ConvND(num_channels[0], out_channels, 3, 1, 1, sd, **kw)
        nn.init.zeros_(self.ConvND_1.Conv_0.weight)  # zero-initialised output conv
        nn.init.zeros_(self.ConvND_1.Conv_0.bias)

    @staticmethod
    def from_config(params: dict, dtype=torch.bfloat16, param_dtype=None,
                    device=None) -> "DiffusionUNet":
        """Raises on ``with_conditioning``: the JAX U-Net then puts a
        ``SpatialTransformer`` at every attention site, which is not ported.
        ``cross_attention_dim`` and ``transformer_num_layers`` are read only
        by that transformer."""
        if params.get("with_conditioning", False):
            raise NotImplementedError(
                "with_conditioning (SpatialTransformer cross-attention, with "
                "cross_attention_dim and transformer_num_layers) is not ported yet")
        return DiffusionUNet(
            spatial_dims=params["spatial_dims"],
            in_channels=params["in_channels"],
            out_channels=params["out_channels"],
            num_channels=tuple(params["num_channels"]),
            attention_levels=tuple(params["attention_levels"]),
            num_head_channels=tuple(params["num_head_channels"]),
            num_res_blocks=params.get("num_res_blocks", 2),
            norm_num_groups=params.get("norm_num_groups", 32),
            strides=tuple(tuple(s) for s in params["strides"]),
            kernel_sizes=tuple(tuple(k) for k in params["kernel_sizes"]),
            paddings=tuple(tuple(p) for p in params["paddings"]),
            num_class_embeds=params.get("num_class_embeds"),
            use_checkpointing=bool(params.get("use_checkpointing", False)),
            dtype=dtype,
            param_dtype=param_dtype,
            device=device,
        )

    def forward(self, x, timesteps, class_labels=None):
        temb = timestep_embedding(timesteps, self.num_channels[0])
        temb = self.Dense_1(F.silu(self.Dense_0(temb)))
        if class_labels is not None and hasattr(self, "Embed_0"):
            temb = temb + self.Embed_0(class_labels)
        temb = temb.to(self.dtype)

        def res_block(i, h):
            return remat_call(getattr(self, f"ResBlock_{i}"), h, self.remat, temb)

        n = len(self.num_channels)
        h = self.ConvND_0(to_internal(x.to(self.dtype).contiguous()))
        rb, ab = 0, 0
        skips = [h]
        for level in range(n):
            for _ in range(self.nrb[level]):
                h = res_block(rb, h)
                rb += 1
                if self.attention_levels[level]:
                    h = getattr(self, f"AttentionBlock_{ab}")(h)
                    ab += 1
                skips.append(h)
            if level != n - 1:
                h = getattr(self, f"Downsample_{level}")(h)
                skips.append(h)

        h = res_block(rb, h)
        h = getattr(self, f"AttentionBlock_{ab}")(h)
        h = res_block(rb + 1, h)
        rb, ab = rb + 2, ab + 1

        for i, level in enumerate(reversed(range(n))):
            for _ in range(self.nrb[level] + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = res_block(rb, h)
                rb += 1
                if self.attention_levels[level]:
                    h = getattr(self, f"AttentionBlock_{ab}")(h)
                    ab += 1
            if level != 0:
                h = getattr(self, f"Upsample_{i}")(h)

        h = self.ConvND_1(self.GroupNorm_0(h, silu=True))
        return to_public(h).float()
