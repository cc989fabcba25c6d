"""PatchGAN discriminator and the least-squares GAN loss of stage-1
autoencoder training.

Port of ``medical_image_generation_tpu/models/discriminator.py`` (:17-69):
a 4-wide conv stack (strides 2, 2, ..., 1, padding 1; the middle convs have
no bias), each middle conv followed by an instance norm, LeakyReLU(0.2)
after every conv but the last, and a 1-channel patch logit map returned in
fp32. The instance norm is ``blocks.GroupNorm`` with one group per channel,
so it runs on the hand-written GroupNorm kernels at one channel a group.
Submodules carry the flax names (``ConvND_0`` .. ``ConvND_n``,
``GroupNorm_0`` ..), so ``convert.vae_from_flax`` maps the JAX
params one to one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_generation_tpu_torch.models.blocks import (
    ConvND,
    GroupNorm,
    to_internal,
    to_public,
)


class PatchDiscriminator(nn.Module):
    """``forward(x)`` with x in (B, *spatial, in_channels) returns fp32
    logits in (B, *patch grid, out_channels). ``param_dtype`` holds the conv
    weights (fp32 masters for training), ``dtype`` is the compute dtype."""

    def __init__(self, spatial_dims=3, in_channels=1, out_channels=1, num_channels=64,
                 num_layers_d=3, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        sd = spatial_dims
        self.dtype = dtype
        self.num_layers_d = num_layers_d
        self.ConvND_0 = ConvND(in_channels, num_channels, 4, 2, 1, sd, **kw)
        ch = num_channels
        for i in range(1, num_layers_d):
            out = min(ch * 2, 512)
            stride = 2 if i < num_layers_d - 1 else 1
            setattr(self, f"ConvND_{i}", ConvND(ch, out, 4, stride, 1, sd, use_bias=False, **kw))
            setattr(self, f"GroupNorm_{i - 1}", GroupNorm(out, out, 1e-6, device))
            ch = out
        setattr(self, f"ConvND_{num_layers_d}", ConvND(ch, out_channels, 4, 1, 1, sd, **kw))

    @staticmethod
    def from_config(params: dict, dtype=torch.bfloat16, param_dtype=None,
                    device=None) -> "PatchDiscriminator":
        return PatchDiscriminator(
            spatial_dims=params["spatial_dims"], in_channels=params["in_channels"],
            out_channels=params["out_channels"], num_channels=params["num_channels"],
            num_layers_d=params["num_layers_d"], dtype=dtype, param_dtype=param_dtype,
            device=device)

    def forward(self, x):
        h = F.leaky_relu(self.ConvND_0(to_internal(x.to(self.dtype).contiguous())), 0.2)
        for i in range(1, self.num_layers_d):
            h = getattr(self, f"GroupNorm_{i - 1}")(getattr(self, f"ConvND_{i}")(h))
            h = F.leaky_relu(h, 0.2)
        return to_public(getattr(self, f"ConvND_{self.num_layers_d}")(h)).float()


def least_squares_gan_loss(logits_real=None, logits_fake=None):
    """LSGAN objectives: the generator's mean((D(fake) - 1)^2) when only
    ``logits_fake`` is given, else the discriminator's
    0.5 * [mean((D(real) - 1)^2) + mean(D(fake)^2)]."""
    if logits_fake is not None and logits_real is None:
        return torch.mean((logits_fake - 1.0) ** 2)
    return 0.5 * (torch.mean((logits_real - 1.0) ** 2) + torch.mean(logits_fake ** 2))
