"""KL-VAE: ``Encoder`` + ``quant_conv_mu`` / ``quant_conv_log_sigma`` and
``encode`` / ``sampling`` / ``encode_stage_2_inputs``; ``post_quant_conv`` +
``Decoder`` and ``decode``.

Port of ``medical_image_generation_tpu/models/autoencoder_kl.py`` (Encoder
:36-81, Decoder :84-131, encode :248-254, sampling :256-258, decode :271-273,
encode_stage_2_inputs :285-289). The encoder's and the decoder's final
GroupNorms have no SiLU. The posterior noise ``eps`` is passed in.

The JAX ``encode`` / ``decode`` run the lane-packed encoder / decoder
(``models/packed_encoder.py``), a TPU lane-packing strategy with the same
math as the plain module path; the port runs the plain module path. The
stage-1 training pieces (discriminator, perceptual loss) are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from medical_image_generation_tpu_torch.models.blocks import (
    AttentionBlock,
    ConvND,
    Downsample,
    GroupNorm,
    ResBlock,
    Upsample,
    per_level,
    to_internal,
    to_public,
)


LOGVAR_MIN, LOGVAR_MAX = -30.0, 20.0


class Encoder(nn.Module):
    """conv_in (level-0 geometry) -> per level ResBlocks (+ attention) and a
    Downsample -> [nonlocal ResBlock/Attention/ResBlock] -> GN -> conv_out."""

    def __init__(self, spatial_dims, num_channels, in_channels, out_channels, num_res_blocks,
                 norm_num_groups, attention_levels, downsample_parameters,
                 with_nonlocal_attn=False, dtype=torch.float32, device=None):
        super().__init__()
        sd, G = spatial_dims, norm_num_groups
        kw = dict(dtype=dtype, device=device)
        self.plan = []  # child names in execution order
        s0, k0, p0 = downsample_parameters[0]
        self.ConvND_0 = ConvND(in_channels, num_channels[0], k0, s0, p0, sd, **kw)
        rb, ab = 0, 0
        ch_in = num_channels[0]

        def add(name, mod):
            setattr(self, name, mod)
            self.plan.append(name)

        for level, ch in enumerate(num_channels):
            for _ in range(num_res_blocks[level]):
                add(f"ResBlock_{rb}", ResBlock(ch_in, ch, G, 1e-6, sd, **kw))
                rb += 1
                ch_in = ch
                if attention_levels[level]:
                    add(f"AttentionBlock_{ab}", AttentionBlock(ch, -1, G, **kw))
                    ab += 1
            if level != len(num_channels) - 1:
                s, k, p = downsample_parameters[level + 1]
                add(f"Downsample_{level}", Downsample(ch, s, k, p, sd, **kw))
        if with_nonlocal_attn:
            ch = num_channels[-1]
            add(f"ResBlock_{rb}", ResBlock(ch, ch, G, 1e-6, sd, **kw))
            add(f"AttentionBlock_{ab}", AttentionBlock(ch, -1, G, **kw))
            add(f"ResBlock_{rb + 1}", ResBlock(ch, ch, G, 1e-6, sd, **kw))
        self.GroupNorm_0 = GroupNorm(num_channels[-1], G, 1e-6, device)
        self.ConvND_1 = ConvND(num_channels[-1], out_channels, 3, 1, 1, sd, **kw)

    def forward(self, x):
        h = self.ConvND_0(x)
        for name in self.plan:
            h = getattr(self, name)(h)
        return self.ConvND_1(self.GroupNorm_0(h, silu=False))


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
    """The KL-VAE on the JAX layout: ``encode(x)`` takes an image in
    (B, *spatial, in_channels) and returns fp32 (mu, sigma) latents in
    (B, *spatial, latent_channels); ``decode(z)`` returns the fp32 image.
    Build from the planner's vae_params with ``from_config``;
    ``with_encoder=False`` builds the decoding half only (what sampling
    needs)."""

    def __init__(self, spatial_dims=3, in_channels=1, out_channels=1,
                 num_channels=(32, 64, 128), latent_channels=8, num_res_blocks=2,
                 norm_num_groups=16, attention_levels=(False, False, False),
                 downsample_parameters=(), upsample_parameters=(),
                 with_encoder_nonlocal_attn=False, with_decoder_nonlocal_attn=False,
                 use_convtranspose=False, with_encoder=True, dtype=torch.float32,
                 device=None):
        super().__init__()
        n = len(num_channels)
        self.dtype = dtype
        if with_encoder:
            self.encoder = Encoder(spatial_dims, num_channels, in_channels, latent_channels,
                                   per_level(num_res_blocks, n), norm_num_groups,
                                   attention_levels, downsample_parameters,
                                   with_encoder_nonlocal_attn, dtype, device)
            self.quant_conv_mu = ConvND(latent_channels, latent_channels, 1, 1, 0,
                                        spatial_dims, dtype=dtype, device=device)
            self.quant_conv_log_sigma = ConvND(latent_channels, latent_channels, 1, 1, 0,
                                               spatial_dims, dtype=dtype, device=device)
        self.post_quant_conv = ConvND(latent_channels, latent_channels, 1, 1, 0, spatial_dims,
                                      dtype=dtype, device=device)
        self.decoder = Decoder(spatial_dims, num_channels, latent_channels, out_channels,
                               per_level(num_res_blocks, n), norm_num_groups,
                               attention_levels, upsample_parameters,
                               with_decoder_nonlocal_attn, use_convtranspose, dtype, device)

    @staticmethod
    def from_config(params: dict, dtype=torch.bfloat16, device=None,
                    with_encoder: bool = True) -> "AutoencoderKL":
        return AutoencoderKL(
            spatial_dims=params["spatial_dims"],
            in_channels=params.get("in_channels", 1),
            out_channels=params["out_channels"],
            num_channels=tuple(params["num_channels"]),
            latent_channels=params["latent_channels"],
            num_res_blocks=params.get("num_res_blocks", 2),
            norm_num_groups=params["norm_num_groups"],
            attention_levels=tuple(params["attention_levels"]),
            downsample_parameters=params.get("downsample_parameters", ()),
            upsample_parameters=params["upsample_parameters"],
            with_encoder_nonlocal_attn=params.get("with_encoder_nonlocal_attn", False),
            with_decoder_nonlocal_attn=params.get("with_decoder_nonlocal_attn", False),
            use_convtranspose=params.get("use_convtranspose", False),
            with_encoder=with_encoder,
            dtype=dtype,
            device=device,
        )

    def encode(self, x):
        """Image (B, *spatial, C) -> fp32 posterior (mu, sigma), log-variance
        clipped to [-30, 20]."""
        h = self.encoder(to_internal(x.to(self.dtype).contiguous()))
        mu = to_public(self.quant_conv_mu(h)).float()
        log_var = to_public(self.quant_conv_log_sigma(h)).float()
        return mu, torch.exp(0.5 * log_var.clamp(LOGVAR_MIN, LOGVAR_MAX))

    @staticmethod
    def sampling(mu, sigma, eps):
        """Posterior sample mu + sigma * eps, with eps ~ N(0, 1) passed in."""
        return mu + sigma * eps

    def encode_stage_2_inputs(self, x, eps):
        """Stochastic stage-2 encode: a posterior sample for the LDM."""
        mu, sigma = self.encode(x)
        return self.sampling(mu, sigma, eps)

    def decode(self, z):
        h = self.post_quant_conv(to_internal(z.to(self.dtype).contiguous()))
        return to_public(self.decoder(h)).float()
