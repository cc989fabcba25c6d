"""KL-VAE decoder side: ``post_quant_conv`` + ``Decoder`` and ``decode``.

Port of ``medical_image_generation_tpu/models/autoencoder_kl.py`` (Decoder
:84-131, decode :271-273). The decoder's final GroupNorm has no SiLU.

The JAX ``decode`` runs the lane-packed decoder
(``models/packed_encoder.py:470-525``), a TPU lane-packing strategy with the
same math as the plain module path; the port runs the plain module path. The
encoder, the posterior sampling and the stage-1 training pieces come with
the training slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from medical_image_generation_tpu_torch.models.blocks import (
    AttentionBlock,
    ConvND,
    GroupNorm,
    ResBlock,
    Upsample,
    per_level,
    to_internal,
    to_public,
)


class Decoder(nn.Module):
    """conv_in -> [nonlocal ResBlock/Attention/ResBlock] -> per level
    (reversed channels) ResBlocks (+ attention) and an Upsample -> GN ->
    conv_out."""

    def __init__(self, spatial_dims, num_channels, in_channels, out_channels, num_res_blocks,
                 norm_num_groups, attention_levels, upsample_parameters,
                 with_nonlocal_attn=False, use_convtranspose=False, dtype=torch.float32,
                 device=None):
        super().__init__()
        sd, G = spatial_dims, norm_num_groups
        kw = dict(dtype=dtype, device=device)
        channels = list(reversed(num_channels))
        attn = list(reversed(attention_levels))
        res_blocks = list(reversed(num_res_blocks))
        self.plan = []  # (kind, name) in execution order
        self.ConvND_0 = ConvND(in_channels, channels[0], 3, 1, 1, sd, **kw)
        rb, ab = 0, 0
        if with_nonlocal_attn:
            for kind, mod in (("res", ResBlock(channels[0], channels[0], G, 1e-6, sd, **kw)),
                              ("attn", AttentionBlock(channels[0], -1, G, **kw)),
                              ("res", ResBlock(channels[0], channels[0], G, 1e-6, sd, **kw))):
                name = f"ResBlock_{rb}" if kind == "res" else f"AttentionBlock_{ab}"
                rb, ab = (rb + 1, ab) if kind == "res" else (rb, ab + 1)
                setattr(self, name, mod)
                self.plan.append(name)
        ch_in = channels[0]
        for level, ch in enumerate(channels):
            for _ in range(res_blocks[level]):
                setattr(self, f"ResBlock_{rb}", ResBlock(ch_in, ch, G, 1e-6, sd, **kw))
                self.plan.append(f"ResBlock_{rb}")
                rb += 1
                ch_in = ch
                if attn[level]:
                    setattr(self, f"AttentionBlock_{ab}", AttentionBlock(ch, -1, G, **kw))
                    self.plan.append(f"AttentionBlock_{ab}")
                    ab += 1
            if level != len(channels) - 1:
                stride = upsample_parameters[level][0]
                setattr(self, f"Upsample_{level}",
                        Upsample(ch, stride, sd, use_convtranspose, **kw))
                self.plan.append(f"Upsample_{level}")
        self.GroupNorm_0 = GroupNorm(channels[-1], G, 1e-6, device)
        self.ConvND_1 = ConvND(channels[-1], out_channels, 3, 1, 1, sd, **kw)

    def forward(self, z):
        h = self.ConvND_0(z)
        for name in self.plan:
            h = getattr(self, name)(h)
        return self.ConvND_1(self.GroupNorm_0(h, silu=False))


class AutoencoderKL(nn.Module):
    """The decoding half of the KL-VAE: ``decode(z)`` takes a latent in
    (B, *spatial, latent_channels) and returns the fp32 image in
    (B, *spatial, out_channels). Build from the planner's vae_params with
    ``from_config``."""

    def __init__(self, spatial_dims=3, out_channels=1, num_channels=(32, 64, 128),
                 latent_channels=8, num_res_blocks=2, norm_num_groups=16,
                 attention_levels=(False, False, False), upsample_parameters=(),
                 with_decoder_nonlocal_attn=False, use_convtranspose=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        n = len(num_channels)
        self.dtype = dtype
        self.post_quant_conv = ConvND(latent_channels, latent_channels, 1, 1, 0, spatial_dims,
                                      dtype=dtype, device=device)
        self.decoder = Decoder(spatial_dims, num_channels, latent_channels, out_channels,
                               per_level(num_res_blocks, n), norm_num_groups,
                               attention_levels, upsample_parameters,
                               with_decoder_nonlocal_attn, use_convtranspose, dtype, device)

    @staticmethod
    def from_config(params: dict, dtype=torch.bfloat16, device=None) -> "AutoencoderKL":
        return AutoencoderKL(
            spatial_dims=params["spatial_dims"],
            out_channels=params["out_channels"],
            num_channels=tuple(params["num_channels"]),
            latent_channels=params["latent_channels"],
            num_res_blocks=params.get("num_res_blocks", 2),
            norm_num_groups=params["norm_num_groups"],
            attention_levels=tuple(params["attention_levels"]),
            upsample_parameters=params["upsample_parameters"],
            with_decoder_nonlocal_attn=params.get("with_decoder_nonlocal_attn", False),
            use_convtranspose=params.get("use_convtranspose", False),
            dtype=dtype,
            device=device,
        )

    def decode(self, z):
        h = self.post_quant_conv(to_internal(z.to(self.dtype).contiguous()))
        return to_public(self.decoder(h)).float()
