"""Plain float32 networks of the planner's configurations: the diffusion
U-Net and the KL-VAE.

Written from the published architecture (VKostoulas/Medical_Image_Generation,
MONAI generative's ``DiffusionModelUNet`` / ``AutoencoderKL`` as the planner
configures them), with the parameter names of the program's modules so that one
seeded state dict loads into both. Layout N C *spatial; every op is a plain
``torch.nn.functional`` call, attention a softmax of a matmul. Nothing here
imports the program.

``precision("fp8")`` computes every convolution, linear layer and attention
product on operands rounded to float8 (e4m3 forward, e5m2 gradients, each
tensor scaled to its own absolute maximum): the control of the output check,
the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_LOW = {"mode": None}


@contextlib.contextmanager
def precision(mode):
    """Compute the products under ``mode`` (None: float32, "fp8")."""
    old = _LOW["mode"]
    _LOW["mode"] = mode
    try:
        yield
    finally:
        _LOW["mode"] = old


def _round8(t, dtype):
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((t * scale).to(dtype).to(t.dtype)) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


class _GradFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


def _q(t):
    return t if t is None or _LOW["mode"] is None else _Fp8.apply(t)


def _gq(t):
    return t if _LOW["mode"] is None else _GradFp8.apply(t)


def matmul(a, b):
    return _gq(torch.matmul(_q(a), _q(b)))


def linear(x, w, b=None):
    return _gq(F.linear(_q(x), _q(w), _q(b)))


class Conv(nn.Module):
    """Convolution held as the child ``Conv_0`` (the program's ``ConvND``)."""

    def __init__(self, cin, cout, k=3, s=1, p=1, sd=3, bias=True):
        super().__init__()
        conv = nn.Conv3d if sd == 3 else nn.Conv2d
        self.Conv_0 = conv(cin, cout, k, stride=s, padding=p, bias=bias, device="meta")

    def forward(self, x):
        c = self.Conv_0
        fn = F.conv3d if x.dim() == 5 else F.conv2d
        return _gq(fn(_q(x), _q(c.weight), _q(c.bias), c.stride, c.padding, c.dilation))


class GroupNorm(nn.Module):
    def __init__(self, ch, groups, eps=1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(ch, device="meta"))
        self.bias = nn.Parameter(torch.empty(ch, device="meta"))

    def forward(self, x, silu=False):
        y = F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        return F.silu(y) if silu else y


class Linear(nn.Linear):
    def __init__(self, cin, cout, bias=True):
        super().__init__(cin, cout, bias=bias, device="meta")

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, groups, sd, temb=None):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(cin, groups)
        self.ConvND_0 = Conv(cin, cout, 3, 1, 1, sd)
        if temb is not None:
            self.Dense_0 = Linear(temb, cout)
        self.GroupNorm_1 = GroupNorm(cout, groups)
        self.ConvND_1 = Conv(cout, cout, 3, 1, 1, sd)
        if cin != cout:
            self.ConvND_2 = Conv(cin, cout, 1, 1, 0, sd)

    def forward(self, x, temb=None):
        h = self.ConvND_0(self.GroupNorm_0(x, True))
        if temb is not None:
            t = self.Dense_0(F.silu(temb))
            h = h + t.reshape(*t.shape, *([1] * (h.dim() - 2)))
        h = self.ConvND_1(self.GroupNorm_1(h, True))
        return (self.ConvND_2(x) if hasattr(self, "ConvND_2") else x) + h


def attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v over (B, H, S, D)."""
    s = matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    return matmul(torch.softmax(s, dim=-1), v)


class AttentionBlock(nn.Module):
    def __init__(self, ch, head_ch, groups):
        super().__init__()
        self.heads = ch // head_ch if head_ch > 0 else 1
        self.GroupNorm_0 = GroupNorm(ch, groups)
        self.Dense_0 = Linear(ch, 3 * ch)
        self.Dense_1 = Linear(ch, ch)

    def forward(self, x):
        B, C = x.shape[:2]
        seq = self.GroupNorm_0(x).flatten(2).transpose(1, 2)  # (B, S, C)
        q, k, v = (t.unflatten(-1, (self.heads, C // self.heads)).transpose(1, 2)
                   for t in self.Dense_0(seq).split(C, dim=-1))
        out = attention(q, k, v).transpose(1, 2).reshape(B, -1, C)
        return x + self.Dense_1(out).transpose(1, 2).reshape(x.shape)


class Downsample(nn.Module):
    def __init__(self, ch, s, k, p, sd):
        super().__init__()
        self.ConvND_0 = Conv(ch, ch, k, s, p, sd)

    def forward(self, x):
        return self.ConvND_0(x)


class Upsample(nn.Module):
    def __init__(self, ch, s, sd):
        super().__init__()
        self.stride = tuple(s)
        self.ConvND_0 = Conv(ch, ch, 3, 1, 1, sd)

    def forward(self, x):
        if any(s > 1 for s in self.stride):
            x = F.interpolate(x, scale_factor=self.stride, mode="nearest")
        return self.ConvND_0(x)


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class UNet(nn.Module):
    """The planner's ``ddpm_params`` U-Net (no class embedding, no context).
    ``forward(x, t)``: x (B, C, *spatial) -> prediction of the same shape."""

    def __init__(self, p):
        super().__init__()
        sd, G = p["spatial_dims"], p.get("norm_num_groups", 32)
        chans, attn = list(p["num_channels"]), list(p["attention_levels"])
        heads, n = list(p["num_head_channels"]), len(p["num_channels"])
        nrb = [p.get("num_res_blocks", 2)] * n
        self.chans, self.attn, self.nrb = chans, attn, nrb
        ted = chans[0] * 4
        self.Dense_0 = Linear(chans[0], ted)
        self.Dense_1 = Linear(ted, ted)
        self.ConvND_0 = Conv(p["in_channels"], chans[0], p["kernel_sizes"][0], p["strides"][0],
                             p["paddings"][0], sd)
        rb = ab = 0
        cin, skips = chans[0], [chans[0]]
        for lv, ch in enumerate(chans):
            for _ in range(nrb[lv]):
                setattr(self, f"ResBlock_{rb}", ResBlock(cin, ch, G, sd, ted))
                rb, cin = rb + 1, ch
                if attn[lv]:
                    setattr(self, f"AttentionBlock_{ab}", AttentionBlock(ch, heads[lv], G))
                    ab += 1
                skips.append(ch)
            if lv != n - 1:
                setattr(self, f"Downsample_{lv}", Downsample(
                    ch, p["strides"][lv + 1], p["kernel_sizes"][lv + 1], p["paddings"][lv + 1], sd))
                skips.append(ch)
        ch = chans[-1]
        setattr(self, f"ResBlock_{rb}", ResBlock(ch, ch, G, sd, ted))
        setattr(self, f"AttentionBlock_{ab}", AttentionBlock(ch, heads[-1], G))
        setattr(self, f"ResBlock_{rb + 1}", ResBlock(ch, ch, G, sd, ted))
        rb, ab = rb + 2, ab + 1
        for i, lv in enumerate(reversed(range(n))):
            ch = chans[lv]
            for _ in range(nrb[lv] + 1):
                setattr(self, f"ResBlock_{rb}", ResBlock(cin + skips.pop(), ch, G, sd, ted))
                rb, cin = rb + 1, ch
                if attn[lv]:
                    setattr(self, f"AttentionBlock_{ab}", AttentionBlock(ch, heads[lv], G))
                    ab += 1
            if lv != 0:
                setattr(self, f"Upsample_{i}", Upsample(ch, p["strides"][lv], sd))
        self.GroupNorm_0 = GroupNorm(chans[0], G)
        self.ConvND_1 = Conv(chans[0], p["out_channels"], 3, 1, 1, sd)

    def timestep_leaves(self) -> set:
        """Names of the leaves on the timestep's path: the time MLP and each
        ResBlock's projection of its output."""
        mods = [("Dense_0", self.Dense_0), ("Dense_1", self.Dense_1)]
        mods += [(f"{n}.Dense_0", m.Dense_0) for n, m in self.named_children()
                 if isinstance(m, ResBlock) and hasattr(m, "Dense_0")]
        return {f"{n}.{p}" for n, m in mods for p, _ in m.named_parameters()}

    def forward(self, x, t):
        temb = self.Dense_1(F.silu(self.Dense_0(timestep_embedding(t, self.chans[0]))))
        n = len(self.chans)
        h = self.ConvND_0(x)
        rb = ab = 0
        skips = [h]
        for lv in range(n):
            for _ in range(self.nrb[lv]):
                h = getattr(self, f"ResBlock_{rb}")(h, temb)
                rb += 1
                if self.attn[lv]:
                    h = getattr(self, f"AttentionBlock_{ab}")(h)
                    ab += 1
                skips.append(h)
            if lv != n - 1:
                h = getattr(self, f"Downsample_{lv}")(h)
                skips.append(h)
        h = getattr(self, f"ResBlock_{rb}")(h, temb)
        h = getattr(self, f"AttentionBlock_{ab}")(h)
        h = getattr(self, f"ResBlock_{rb + 1}")(h, temb)
        rb, ab = rb + 2, ab + 1
        for i, lv in enumerate(reversed(range(n))):
            for _ in range(self.nrb[lv] + 1):
                h = getattr(self, f"ResBlock_{rb}")(torch.cat([h, skips.pop()], 1), temb)
                rb += 1
                if self.attn[lv]:
                    h = getattr(self, f"AttentionBlock_{ab}")(h)
                    ab += 1
            if lv != 0:
                h = getattr(self, f"Upsample_{i}")(h)
        return self.ConvND_1(self.GroupNorm_0(h, True))


class _Coder(nn.Module):
    def __init__(self):
        super().__init__()
        self.plan = []

    def add(self, name, mod):
        setattr(self, name, mod)
        self.plan.append(name)

    def forward(self, x):
        h = self.ConvND_0(x)
        for name in self.plan:
            h = getattr(self, name)(h)
        return self.ConvND_1(self.GroupNorm_0(h))


class Encoder(_Coder):
    def __init__(self, p):
        super().__init__()
        sd, G, chans = p["spatial_dims"], p["norm_num_groups"], list(p["num_channels"])
        ds = p["downsample_parameters"]
        s0, k0, p0 = ds[0]
        self.ConvND_0 = Conv(p.get("in_channels", 1), chans[0], k0, s0, p0, sd)
        rb, cin = 0, chans[0]
        for lv, ch in enumerate(chans):
            for _ in range(p.get("num_res_blocks", 2)):
                self.add(f"ResBlock_{rb}", ResBlock(cin, ch, G, sd))
                rb, cin = rb + 1, ch
            if lv != len(chans) - 1:
                s, k, pad = ds[lv + 1]
                self.add(f"Downsample_{lv}", Downsample(ch, s, k, pad, sd))
        self.GroupNorm_0 = GroupNorm(chans[-1], G)
        self.ConvND_1 = Conv(chans[-1], p["latent_channels"], 3, 1, 1, sd)


class Decoder(_Coder):
    def __init__(self, p):
        super().__init__()
        sd, G = p["spatial_dims"], p["norm_num_groups"]
        chans = list(reversed(p["num_channels"]))
        self.ConvND_0 = Conv(p["latent_channels"], chans[0], 3, 1, 1, sd)
        rb, cin = 0, chans[0]
        for lv, ch in enumerate(chans):
            for _ in range(p.get("num_res_blocks", 2)):
                self.add(f"ResBlock_{rb}", ResBlock(cin, ch, G, sd))
                rb, cin = rb + 1, ch
            if lv != len(chans) - 1:
                self.add(f"Upsample_{lv}", Upsample(ch, p["upsample_parameters"][lv][0], sd))
        self.GroupNorm_0 = GroupNorm(chans[-1], G)
        self.ConvND_1 = Conv(chans[-1], p["out_channels"], 3, 1, 1, sd)


class AutoencoderKL(nn.Module):
    """The planner's ``vae_params`` KL-VAE (no attention levels, no
    non-local attention, nearest + conv upsampling)."""

    def __init__(self, p):
        super().__init__()
        if any(p["attention_levels"]) or p.get("with_encoder_nonlocal_attn") \
                or p.get("with_decoder_nonlocal_attn") or p.get("use_convtranspose"):
            raise NotImplementedError("attention or transposed convs in the KL-VAE")
        sd, L = p["spatial_dims"], p["latent_channels"]
        self.encoder = Encoder(p)
        self.quant_conv_mu = Conv(L, L, 1, 1, 0, sd)
        self.quant_conv_log_sigma = Conv(L, L, 1, 1, 0, sd)
        self.post_quant_conv = Conv(L, L, 1, 1, 0, sd)
        self.decoder = Decoder(p)

    def encode(self, x):
        """(mu, sigma) of an image (B, C, *spatial); log-variance clipped to
        [-30, 20]."""
        h = self.encoder(x)
        log_var = self.quant_conv_log_sigma(h).clamp(-30.0, 20.0)
        return self.quant_conv_mu(h), torch.exp(0.5 * log_var)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def norm_weights(model: nn.Module):
    """Names of the normalisation scales (drawn around 1)."""
    return {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, GroupNorm)}
