"""VQ-VAE: the ``vq`` latent space of both trainers.

Port of ``medical_image_generation_tpu/models/vqvae.py`` (VectorQuantizer
:23-52, VQVAE :55-157): the strided ``Encoder`` / ``Decoder`` of the
KL-VAE (the encoder emits ``embedding_dim`` channels; no quant convs) and a
straight-through vector quantizer. The codebook is initialised uniform in
[0, 2 / num_embeddings) (flax ``uniform(scale)``); distances and the argmin
are fp32; the loss is codebook + 0.25 * commitment.

The JAX ``encode`` / ``decode`` run the lane-packed encoder / decoder
(``models/packed_encoder.py``), a TPU lane-packing strategy with the same
math as the plain module path; the port runs the module path.
``use_checkpointing`` / ``remat_policy`` (JAX :66-124) reach the same
Encoder / Decoder as the KL-VAE's (``autoencoder_kl.remat_call``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from medical_image_generation_tpu_torch.models.autoencoder_kl import (
    Decoder,
    Encoder,
    validate_remat_policy,
)
from medical_image_generation_tpu_torch.models.blocks import per_level, to_internal, to_public


class VectorQuantizer(nn.Module):
    """Straight-through VQ over the last (channel) axis of a (B, *spatial,
    D) latent; ``forward(z)`` returns (quantized in z's dtype, fp32 vq
    loss, codes (B, *spatial))."""

    def __init__(self, num_embeddings: int = 256, embedding_dim: int = 8,
                 commitment_cost: float = 0.25, device=None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.codebook = nn.Parameter(
            torch.rand((num_embeddings, embedding_dim), device=device) * (2.0 / num_embeddings))

    def forward(self, z):
        z32 = z.float()
        flat = z32.reshape(-1, self.embedding_dim)
        cb = self.codebook
        d2 = (flat.square().sum(dim=1, keepdim=True) - 2.0 * flat @ cb.t()
              + cb.square().sum(dim=1)[None, :])
        codes = torch.argmin(d2, dim=1)
        quantized = cb[codes].reshape(z32.shape)
        codebook_loss = torch.mean((quantized - z32.detach()) ** 2)
        commit_loss = torch.mean((quantized.detach() - z32) ** 2)
        vq_loss = codebook_loss + self.commitment_cost * commit_loss
        quantized = z32 + (quantized - z32).detach()  # straight-through estimator
        return quantized.to(z.dtype), vq_loss, codes.reshape(z.shape[:-1])


class VQVAE(nn.Module):
    """``forward(x)`` -> (fp32 reconstruction, vq loss); ``encode``,
    ``quantize``, ``decode`` and the stage-2 hooks in the JAX layout
    (B, *spatial, C). ``with_encoder=False`` builds the quantizer and the
    decoder only (what sampling needs)."""

    def __init__(self, spatial_dims=3, in_channels=1, out_channels=1,
                 num_channels=(32, 64, 128), num_res_blocks=2, norm_num_groups=16,
                 attention_levels=(False, False, False), downsample_parameters=(),
                 upsample_parameters=(), num_embeddings=256, embedding_dim=8,
                 use_checkpointing=False, remat_policy="acts", with_encoder=True,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        n = len(num_channels)
        self.dtype = dtype
        validate_remat_policy(remat_policy)
        kw = dict(remat=remat_policy if use_checkpointing else None, dtype=dtype,
                  param_dtype=param_dtype, device=device)
        if with_encoder:
            self.encoder = Encoder(spatial_dims, num_channels, in_channels, embedding_dim,
                                   per_level(num_res_blocks, n), norm_num_groups,
                                   attention_levels, downsample_parameters, **kw)
        self.decoder = Decoder(spatial_dims, num_channels, embedding_dim, out_channels,
                               per_level(num_res_blocks, n), norm_num_groups,
                               attention_levels, upsample_parameters, **kw)
        self.quantizer = VectorQuantizer(num_embeddings, embedding_dim, device=device)

    @staticmethod
    def from_config(params: dict, dtype=torch.bfloat16, param_dtype=None, device=None,
                    with_encoder: bool = True) -> "VQVAE":
        n = len(params["num_channels"])
        return VQVAE(
            spatial_dims=params["spatial_dims"],
            in_channels=params.get("in_channels", 1),
            out_channels=params["out_channels"],
            num_channels=tuple(params["num_channels"]),
            num_res_blocks=params.get("num_res_blocks", params.get("num_res_layers", 2)),
            norm_num_groups=params.get("norm_num_groups", 16),
            attention_levels=tuple(params.get("attention_levels", [False] * n)),
            downsample_parameters=params.get("downsample_parameters", ()),
            upsample_parameters=params["upsample_parameters"],
            num_embeddings=params.get("num_embeddings", 256),
            embedding_dim=params.get("embedding_dim", 8),
            use_checkpointing=bool(params.get("use_checkpointing", False)),
            remat_policy=params.get("remat_policy", "acts"),
            with_encoder=with_encoder, dtype=dtype, param_dtype=param_dtype, device=device)

    def encode(self, x):
        """Image -> pre-quantization latent (B, *latent, embedding_dim), in
        the compute dtype."""
        return to_public(self.encoder(to_internal(x.to(self.dtype).contiguous())))

    def quantize(self, z):
        return self.quantizer(z)

    def decode(self, zq):
        return to_public(self.decoder(to_internal(zq.to(self.dtype).contiguous()))).float()

    def forward(self, x):
        zq, vq_loss, _ = self.quantize(self.encode(x))
        return self.decode(zq), vq_loss

    def encode_stage_2_inputs(self, x):
        return self.encode(x)

    def decode_stage_2_outputs(self, z):
        return self.decode(self.quantize(z)[0])
