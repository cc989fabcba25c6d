"""Strided diffusion U-Net (2D/3D) and its encoder half; trained through
autograd (the GroupNorm and attention kernels are autograd Functions).

Port of ``DiffusionUNet`` (``medical_image_generation_tpu/models/
diffusion_unet.py:109-285``): fp32 time MLP, optional class embedding,
down path collecting skips, mid block (ResBlock, attention, ResBlock), up
path with skip concatenation, and GN -> SiLU -> conv to an fp32 output.
Submodule names follow the flax tree (``Dense_0``, ``Embed_0``,
``ConvND_0``, ``ResBlock_i``, ``AttentionBlock_k``, ``Downsample_k``,
``Upsample_k``, ``GroupNorm_0``, ``ConvND_1``).

``with_conditioning`` puts a ``SpatialTransformer_k`` (JAX :36-106: GN,
1x1 in-projection, ``transformer_num_layers`` blocks of self-attention,
attention to ``context`` and a GEGLU MLP over the flattened grid, then a
zero-initialised 1x1 out-projection and the residual) at every attention
site in place of ``AttentionBlock_k``, with ``max(1, ch //
num_head_channels[level])`` heads. Both attentions run through the flash
kernels; without a ``context`` (no trainer passes one) the second attends
to the block's own tokens. The LayerNorms have eps 1e-6 and the GELU is
the tanh approximation, as flax's defaults are. The flax module sizes the
key / value projections from the context it is initialised with. The
trainers initialise without one, so there they map ``channels`` to
``channels``, and ``cross_attention_dim`` is read by neither package's
U-Net (``from_config`` ignores it). ``DiffusionUNet(context_dim=E)`` (or
``from_config(..., context_dim=E)``) builds every transformer's key / value
projections for a context of width E, the tree flax initialises with a
(B, Sk, E) context: ``forward(x, t, context=c)`` then attends to c's Sk
tokens at every site, through the same flash kernels (Sk of its own).

``forward`` takes the ControlNet residuals (JAX :234-249):
``down_block_additional_residuals`` added to the collected skips (zipped,
as JAX does) and ``mid_block_additional_residual`` to the mid block's
output, both in the public (B, *spatial, C) layout.

``use_checkpointing`` (JAX :133, :156, :178, ``nn.remat(ResBlock)``)
rematerialises every ResBlock in the backward pass: each runs under a
non-reentrant ``torch.utils.checkpoint`` with no policy
(``autoencoder_kl.remat_call`` with ``"full"``), so only the block's inputs
are kept across the forward and its GroupNorm forward kernels run again in
the backward. Attention blocks and spatial transformers are not
rematerialised, as in JAX. The flag changes no parameter name and no
result; under ``no_grad`` (sampling) it does nothing.

MAISI's conditioning (MONAI ``DiffusionModelUNetMaisi``, the U-Net of the
``maisi_ct_generative`` bundle): ``include_top_region_index_input``,
``include_bottom_region_index_input`` and ``include_spacing_input`` each add
an fp32 MLP ``Linear(n, ted) -> SiLU -> Linear(ted, ted)`` (ted = 4 x
``num_channels[0]``; n = 4 body regions as a one-hot, or the 3 voxel
spacings) named as MONAI names it (``top_region_index_layer``,
``bottom_region_index_layer``, ``spacing_layer``). Their outputs are
concatenated after the time MLP's (after the class embedding is added), in
that order, so every ResBlock's projection takes ted times one plus their
number. ``forward`` takes them as ``top_region_index_tensor``,
``bottom_region_index_tensor`` and ``spacing_tensor`` ((B, 4), (B, 4), (B,
3)). They are registered after every other module, so the parameter names
and their order are those of the U-Net without them, and with all three off
the module is exactly the U-Net without them.

``DiffusionEncoder`` (JAX :288-347) is the down path with a global average
pool and a linear head: a timestep-conditioned classifier.
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
    Linear,
    ResBlock,
    Upsample,
    per_level,
    timestep_embedding,
    to_internal,
    to_public,
)
from medical_image_generation_tpu_torch.ops.attention import dot_product_attention

LN_EPS = 1e-6  # flax nn.LayerNorm's default


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics over the last
    axis, eps 1e-6, fp32 scale and bias; returns fp32."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, LN_EPS)


class CrossAttention(nn.Module):
    """Bias-free q / k / v projections (``Dense_0-2``), attention over
    ``num_heads`` heads with scale head_dim^-0.5, and the out-projection
    ``Dense_3``; k and v come from ``context`` (default: x itself). x is
    (B, S, C), context (B, Sk, context_dim)."""

    def __init__(self, query_dim: int, num_heads: int = 1, context_dim: Optional[int] = None,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        cd = context_dim or query_dim
        self.num_heads = num_heads
        self.head_dim = query_dim // num_heads
        self.Dense_0 = Linear(query_dim, query_dim, bias=False, **kw)
        self.Dense_1 = Linear(cd, query_dim, bias=False, **kw)
        self.Dense_2 = Linear(cd, query_dim, bias=False, **kw)
        self.Dense_3 = Linear(query_dim, query_dim, **kw)

    def forward(self, x, context=None):
        context = x if context is None else context
        B, S, C = x.shape
        q, k, v = (t.unflatten(-1, (self.num_heads, self.head_dim)) for t in (
            self.Dense_0(x), self.Dense_1(context), self.Dense_2(context)))
        return self.Dense_3(dot_product_attention(q, k, v).reshape(B, S, C))


class TransformerBlock(nn.Module):
    """x + attn(LN x), x + attn(LN x, context), x + GEGLU MLP(LN x) (JAX
    :55-74): the LayerNorms in fp32, the rest in ``dtype``."""

    def __init__(self, channels: int, num_heads: int, context_dim: Optional[int] = None,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(channels, device)
        self.CrossAttention_0 = CrossAttention(channels, num_heads, None, **kw)
        self.LayerNorm_1 = LayerNorm(channels, device)
        self.CrossAttention_1 = CrossAttention(channels, num_heads, context_dim, **kw)
        self.LayerNorm_2 = LayerNorm(channels, device)
        self.Dense_0 = Linear(channels, channels * 8, **kw)
        self.Dense_1 = Linear(channels * 4, channels, **kw)

    def forward(self, x, context=None):
        d = self.dtype
        x = x + self.CrossAttention_0(self.LayerNorm_0(x).to(d))
        ctx = None if context is None else context.to(d)
        x = x + self.CrossAttention_1(self.LayerNorm_1(x).to(d), ctx)
        a, g = self.Dense_0(self.LayerNorm_2(x).to(d)).chunk(2, dim=-1)
        return x + self.Dense_1(a * F.gelu(g, approximate="tanh"))


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 in-projection -> ``num_layers`` TransformerBlocks
    over the flattened grid -> zero-initialised 1x1 out-projection, plus the
    residual (JAX :77-106). x is N C *spatial (channels-last memory)."""

    def __init__(self, channels: int, num_heads: int, num_layers: int = 1,
                 norm_num_groups: int = 32, spatial_dims: int = 3,
                 context_dim: Optional[int] = None, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_layers = num_layers
        self.GroupNorm_0 = GroupNorm(channels, norm_num_groups, 1e-6, device)
        self.ConvND_0 = ConvND(channels, channels, 1, 1, 0, spatial_dims, **kw)
        for i in range(num_layers):
            setattr(self, f"TransformerBlock_{i}",
                    TransformerBlock(channels, num_heads, context_dim, **kw))
        self.ConvND_1 = ConvND(channels, channels, 1, 1, 0, spatial_dims, **kw)
        nn.init.zeros_(self.ConvND_1.Conv_0.weight)  # zero-initialised out-projection
        nn.init.zeros_(self.ConvND_1.Conv_0.bias)

    def forward(self, x, context=None):
        B, C = x.shape[:2]
        spatial = x.shape[2:]
        h = self.ConvND_0(self.GroupNorm_0(x))
        h = to_public(h).reshape(B, -1, C)  # (B, S, C) view of channels-last memory
        for i in range(self.num_layers):
            h = getattr(self, f"TransformerBlock_{i}")(h, context)
        h = to_internal(h.reshape(B, *spatial, C))
        return x + self.ConvND_1(h)


class DiffusionUNet(nn.Module):
    """``forward(x, timesteps, class_labels=None)`` with x in (B, *spatial,
    C_in) returns the fp32 prediction in (B, *spatial, C_out). Build from the
    planner's ddpm_params with ``from_config``. ``param_dtype`` (default:
    ``dtype``) holds the conv / linear weights: fp32 for training with bf16
    compute. ``context_dim`` (needs ``with_conditioning``) sizes the
    transformers' key / value projections for ``forward``'s (B, Sk,
    context_dim) context; None maps each site's own channels. The three
    ``include_*`` flags add MAISI's embedding MLPs (module docstring)."""

    EMBEDDINGS = (("top_region_index", 4), ("bottom_region_index", 4), ("spacing", 3))

    def __init__(self, spatial_dims=3, in_channels=8, out_channels=8,
                 num_channels=(256, 512, 768), attention_levels=(False, True, True),
                 num_head_channels=(0, 512, 768), num_res_blocks=2, norm_num_groups=32,
                 strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
                 kernel_sizes=((3, 3, 3),) * 3, paddings=((1, 1, 1),) * 3,
                 num_class_embeds: Optional[int] = None, use_checkpointing: bool = False,
                 with_conditioning: bool = False, transformer_num_layers: int = 1,
                 context_dim: Optional[int] = None,
                 include_top_region_index_input: bool = False,
                 include_bottom_region_index_input: bool = False,
                 include_spacing_input: bool = False, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        if context_dim is not None and not with_conditioning:
            raise ValueError("context_dim sizes the SpatialTransformers' key / value "
                             "projections: it needs with_conditioning=True")
        n = len(num_channels)
        nrb = per_level(num_res_blocks, n)
        self.dtype = dtype
        self.num_channels = tuple(num_channels)
        self.attention_levels = tuple(attention_levels)
        self.nrb = nrb
        self.attn_name = "SpatialTransformer" if with_conditioning else "AttentionBlock"
        self.remat = "full" if use_checkpointing else None  # remat_call's policy
        sd, G = spatial_dims, norm_num_groups
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        ted = num_channels[0] * 4
        included = (include_top_region_index_input, include_bottom_region_index_input,
                    include_spacing_input)
        self.embeddings = tuple(e for e, on in zip(self.EMBEDDINGS, included) if on)
        self.Dense_0 = nn.Linear(num_channels[0], ted, device=device)  # fp32 time MLP
        self.Dense_1 = nn.Linear(ted, ted, device=device)
        if num_class_embeds is not None:
            self.Embed_0 = nn.Embedding(num_class_embeds, ted, device=device)
        self.ConvND_0 = ConvND(in_channels, num_channels[0], kernel_sizes[0], strides[0],
                               paddings[0], sd, **kw)
        emb_ch = ted * (1 + len(self.embeddings))  # what each ResBlock projects

        def attn(level, ch):
            hc = num_head_channels[level]
            if with_conditioning:
                heads = max(1, ch // hc) if hc > 0 else 1
                return SpatialTransformer(ch, heads, transformer_num_layers, G, sd,
                                          context_dim, **kw)
            return AttentionBlock(ch, hc if hc > 0 else -1, G, **kw)

        rb, ab = 0, 0
        ch_in = num_channels[0]
        skip_ch = [ch_in]
        for level, ch in enumerate(num_channels):
            for _ in range(nrb[level]):
                setattr(self, f"ResBlock_{rb}", ResBlock(ch_in, ch, G, 1e-6, sd, emb_ch, **kw))
                rb += 1
                ch_in = ch
                if attention_levels[level]:
                    setattr(self, f"{self.attn_name}_{ab}", attn(level, ch))
                    ab += 1
                skip_ch.append(ch)
            if level != n - 1:
                setattr(self, f"Downsample_{level}",
                        Downsample(ch, strides[level + 1], kernel_sizes[level + 1],
                                   paddings[level + 1], sd, **kw))
                skip_ch.append(ch)
        ch = num_channels[-1]
        setattr(self, f"ResBlock_{rb}", ResBlock(ch, ch, G, 1e-6, sd, emb_ch, **kw))
        setattr(self, f"{self.attn_name}_{ab}", attn(n - 1, ch))
        setattr(self, f"ResBlock_{rb + 1}", ResBlock(ch, ch, G, 1e-6, sd, emb_ch, **kw))
        rb, ab = rb + 2, ab + 1
        for i, level in enumerate(reversed(range(n))):
            ch = num_channels[level]
            for _ in range(nrb[level] + 1):
                setattr(self, f"ResBlock_{rb}",
                        ResBlock(ch_in + skip_ch.pop(), ch, G, 1e-6, sd, emb_ch, **kw))
                rb += 1
                ch_in = ch
                if attention_levels[level]:
                    setattr(self, f"{self.attn_name}_{ab}", attn(level, ch))
                    ab += 1
            if level != 0:
                setattr(self, f"Upsample_{i}", Upsample(ch, strides[level], sd, **kw))
        self.GroupNorm_0 = GroupNorm(num_channels[0], G, 1e-6, device)
        self.ConvND_1 = ConvND(num_channels[0], out_channels, 3, 1, 1, sd, **kw)
        nn.init.zeros_(self.ConvND_1.Conv_0.weight)  # zero-initialised output conv
        nn.init.zeros_(self.ConvND_1.Conv_0.bias)
        for name, n_in in self.embeddings:  # fp32, as the time MLP
            setattr(self, f"{name}_layer", nn.Sequential(
                nn.Linear(n_in, ted, device=device), nn.SiLU(),
                nn.Linear(ted, ted, device=device)))

    @staticmethod
    def from_config(params: dict, dtype=torch.bfloat16, param_dtype=None, device=None,
                    context_dim: Optional[int] = None) -> "DiffusionUNet":
        """The U-Net of the planner's ddpm_params (``cross_attention_dim`` sizes
        nothing, as in JAX), or of MAISI's with its ``include_*`` keys;
        ``context_dim`` as in ``DiffusionUNet``."""
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
            with_conditioning=bool(params.get("with_conditioning", False)),
            transformer_num_layers=int(params.get("transformer_num_layers", 1)),
            context_dim=context_dim,
            include_top_region_index_input=bool(
                params.get("include_top_region_index_input", False)),
            include_bottom_region_index_input=bool(
                params.get("include_bottom_region_index_input", False)),
            include_spacing_input=bool(params.get("include_spacing_input", False)),
            dtype=dtype,
            param_dtype=param_dtype,
            device=device,
        )

    def forward(self, x, timesteps, context=None, class_labels=None,
                down_block_additional_residuals=None, mid_block_additional_residual=None,
                **embedding_inputs):
        d = self.dtype
        temb = timestep_embedding(timesteps, self.num_channels[0])
        temb = self.Dense_1(F.silu(self.Dense_0(temb)))
        if class_labels is not None and hasattr(self, "Embed_0"):
            temb = temb + self.Embed_0(class_labels)
        if self.embeddings or embedding_inputs:
            temb = torch.cat([temb, *self._embed(embedding_inputs)], dim=1)
        temb = temb.to(d)

        def res_block(i, h):
            return remat_call(getattr(self, f"ResBlock_{i}"), h, self.remat, temb)

        def attn(i, h):
            block = getattr(self, f"{self.attn_name}_{i}")
            return block(h, context) if self.attn_name == "SpatialTransformer" else block(h)

        n = len(self.num_channels)
        h = self.ConvND_0(to_internal(x.to(d).contiguous()))
        rb, ab = 0, 0
        skips = [h]
        for level in range(n):
            for _ in range(self.nrb[level]):
                h = res_block(rb, h)
                rb += 1
                if self.attention_levels[level]:
                    h = attn(ab, h)
                    ab += 1
                skips.append(h)
            if level != n - 1:
                h = getattr(self, f"Downsample_{level}")(h)
                skips.append(h)
        if down_block_additional_residuals is not None:
            skips = [s + to_internal(r.to(d)) for s, r in zip(skips, down_block_additional_residuals)]

        h = res_block(rb, h)
        h = attn(ab, h)
        h = res_block(rb + 1, h)
        rb, ab = rb + 2, ab + 1
        if mid_block_additional_residual is not None:
            h = h + to_internal(mid_block_additional_residual.to(d))

        for i, level in enumerate(reversed(range(n))):
            for _ in range(self.nrb[level] + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = res_block(rb, h)
                rb += 1
                if self.attention_levels[level]:
                    h = attn(ab, h)
                    ab += 1
            if level != 0:
                h = getattr(self, f"Upsample_{i}")(h)

        h = self.ConvND_1(self.GroupNorm_0(h, silu=True))
        return to_public(h).float()

    def _embed(self, inputs: dict) -> list:
        """The MAISI embeddings of ``inputs`` ({``<name>_tensor``: (B, n)}),
        in the order of ``EMBEDDINGS``; every one the model includes must be
        given, and no other."""
        want = {f"{name}_tensor" for name, _ in self.embeddings}
        if set(inputs) != want:
            raise ValueError(f"this U-Net takes the embedding inputs {sorted(want)}, "
                             f"got {sorted(inputs)}")
        return [getattr(self, f"{name}_layer")(inputs[f"{name}_tensor"].float())
                for name, _ in self.embeddings]


class DiffusionEncoder(nn.Module):
    """``forward(x, timesteps)`` with x in (B, *spatial, C_in) returns fp32
    logits (B, num_classes): the fp32 time MLP (``Dense_0``, ``Dense_1``),
    ``ConvND_0``, per level ``num_res_blocks`` ResBlocks (each followed by an
    ``AttentionBlock`` at the attention levels) and a ``Downsample`` between
    levels, then GroupNorm + SiLU, the mean over the grid and the fp32 head
    ``Dense_2``."""

    def __init__(self, spatial_dims=3, in_channels=8, num_classes=2,
                 num_channels=(256, 512, 768), attention_levels=(False, True, True),
                 num_head_channels=(0, 512, 768), num_res_blocks=2, norm_num_groups=32,
                 strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
                 kernel_sizes=((3, 3, 3),) * 3, paddings=((1, 1, 1),) * 3,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        n = len(num_channels)
        self.nrb = per_level(num_res_blocks, n)
        self.dtype = dtype
        self.num_channels = tuple(num_channels)
        self.plan = []  # module names in execution order
        sd, G = spatial_dims, norm_num_groups
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        ted = num_channels[0] * 4
        self.Dense_0 = nn.Linear(num_channels[0], ted, device=device)  # fp32 time MLP
        self.Dense_1 = nn.Linear(ted, ted, device=device)
        self.ConvND_0 = ConvND(in_channels, num_channels[0], kernel_sizes[0], strides[0],
                               paddings[0], sd, **kw)
        rb, ab = 0, 0
        ch_in = num_channels[0]
        for level, ch in enumerate(num_channels):
            for _ in range(self.nrb[level]):
                setattr(self, f"ResBlock_{rb}", ResBlock(ch_in, ch, G, 1e-6, sd, ted, **kw))
                self.plan.append(f"ResBlock_{rb}")
                rb += 1
                ch_in = ch
                if attention_levels[level]:
                    hc = num_head_channels[level]
                    setattr(self, f"AttentionBlock_{ab}",
                            AttentionBlock(ch, hc if hc > 0 else -1, G, **kw))
                    self.plan.append(f"AttentionBlock_{ab}")
                    ab += 1
            if level != n - 1:
                setattr(self, f"Downsample_{level}",
                        Downsample(ch, strides[level + 1], kernel_sizes[level + 1],
                                   paddings[level + 1], sd, **kw))
                self.plan.append(f"Downsample_{level}")
        self.GroupNorm_0 = GroupNorm(num_channels[-1], G, 1e-6, device)
        self.Dense_2 = nn.Linear(num_channels[-1], num_classes, device=device)  # fp32 head

    def forward(self, x, timesteps):
        temb = timestep_embedding(timesteps, self.num_channels[0])
        temb = self.Dense_1(F.silu(self.Dense_0(temb))).to(self.dtype)
        h = self.ConvND_0(to_internal(x.to(self.dtype).contiguous()))
        for name in self.plan:
            mod = getattr(self, name)
            h = mod(h, temb) if name.startswith("ResBlock") else mod(h)
        h = self.GroupNorm_0(h, silu=True).mean(dim=tuple(range(2, h.dim())))
        return self.Dense_2(h.float())
