"""MAISI's diffusion U-Net and its training step on precomputed latents, in
plain float32 PyTorch.

MAISI (Guo et al., arXiv:2409.11169; the MONAI bundle ``maisi_ct_generative``,
``configs/config_maisi.json`` ``diffusion_unet_def``, MONAI's
``DiffusionModelUNetMaisi``) is the U-Net of ``nets.UNet`` with three
embedding MLPs on the time embedding's path: a top and a bottom body region,
each a one-hot over 4 regions, and the 3 voxel spacings, each
``Linear(n, ted) -> SiLU -> Linear(ted, ted)`` (ted = 4 x ``num_channels[0]``).
Their outputs are concatenated after the time MLP's, in that order, so every
ResBlock's projection takes ted times one plus their number. The MLPs'
structure and the concatenation are written from the bundle's description;
the configuration file lists them under ``assumed``. Names follow the
program's modules (MONAI's for the MLPs), registered after every other
module, so that one seeded state dict loads into both.

Attention is ``nets.AttentionBlock``'s (heads of ``num_head_channels``; the
roofline counter reads its heads), computed a block of query rows at a time,
each block under ``torch.utils.checkpoint``: no score matrix of more than
``SCORE_ELEMS`` entries is held (the whole one at 32768 tokens and 8 heads
would take 34 GB in float32), and the backward recomputes one block at a
time. On the meta device (the operation count) it is one call, so
recomputation is not counted.

``follow`` is the step as the program runs it: the scale ``1 / std`` of the
first latent batch (``torch.std``'s unbiased estimate, MAISI's
``calculate_scale_factor``), then each step the scaled latent noised at the
drawn timestep on the DDPM schedule, the epsilon MSE, the clip by global norm
and AdamW with the configuration's decay (``ldm.AdamW``). TF32 is off for
every product.

Departures from the bundle, in the program and here alike: bfloat16 compute
in the program where the bundle autocasts to float16; the port's AdamW with
weight decay 0 where the bundle uses ``torch.optim.Adam``; the port's clip at
1.0, kept so that the clip's norm is compared; the MSE of the port's step,
where the bundle's training script may take another loss; a constant
learning rate over the checked steps.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import ldm, nets

EMBEDDINGS = (("top_region_index", 4, "include_top_region_index_input"),
              ("bottom_region_index", 4, "include_bottom_region_index_input"),
              ("spacing", 3, "include_spacing_input"))
SCORE_ELEMS = 2 ** 28  # entries of one block's score matrix: 1 GiB in float32


def chunked_attention(q, k, v, score_elems: int = SCORE_ELEMS):
    """``nets.attention`` over (B, H, S, D), ``score_elems // (B H Sk)`` query
    rows at a time, each block checkpointed."""
    B, H, S, _ = q.shape
    rows = max(1, score_elems // (B * H * k.shape[2]))
    if q.device.type == "meta" or rows >= S:
        return nets.attention(q, k, v)
    return torch.cat([checkpoint(nets.attention, q[:, :, i:i + rows], k, v, use_reentrant=False)
                      for i in range(0, S, rows)], dim=2)


class AttentionBlock(nets.AttentionBlock):
    """``nets.AttentionBlock`` with its attention in checkpointed blocks of
    query rows."""

    def forward(self, x):
        B, C = x.shape[:2]
        seq = self.GroupNorm_0(x).flatten(2).transpose(1, 2)  # (B, S, C)
        q, k, v = (t.unflatten(-1, (self.heads, C // self.heads)).transpose(1, 2)
                   for t in self.Dense_0(seq).split(C, dim=-1))
        out = chunked_attention(q, k, v).transpose(1, 2).reshape(B, -1, C)
        return x + self.Dense_1(out).transpose(1, 2).reshape(x.shape)


class UNet(nets.UNet):
    """MAISI's U-Net: ``forward(x, t, **inputs)`` with x (B, C, *spatial) and
    ``<name>_tensor`` (B, n) for each embedding the configuration includes."""

    def __init__(self, p):
        super().__init__(p)
        ted = self.chans[0] * 4
        self.embeddings = [(name, n) for name, n, key in EMBEDDINGS if p.get(key)]
        width = ted * (1 + len(self.embeddings))
        for name, m in list(self.named_children()):
            if isinstance(m, nets.ResBlock):
                m.Dense_0 = nets.Linear(width, m.Dense_0.out_features)
            elif isinstance(m, nets.AttentionBlock):
                C = m.Dense_1.in_features
                setattr(self, name, AttentionBlock(C, C // m.heads, m.GroupNorm_0.groups))
        for name, n in self.embeddings:
            setattr(self, f"{name}_layer", nn.Sequential(nets.Linear(n, ted), nn.SiLU(),
                                                         nets.Linear(ted, ted)))

    def timestep_leaves(self) -> set:
        """The time MLP's, the embedding MLPs' and each ResBlock's projection's
        leaves: everything on the embedding's path."""
        return super().timestep_leaves() | {
            f"{name}_layer.{p}" for name, _ in self.embeddings
            for p, _ in getattr(self, f"{name}_layer").named_parameters()}

    def forward(self, x, t, **inputs):
        want = {f"{name}_tensor" for name, _ in self.embeddings}
        if set(inputs) != want:
            raise ValueError(f"expected the inputs {sorted(want)}, got {sorted(inputs)}")
        temb = self.Dense_1(F.silu(self.Dense_0(nets.timestep_embedding(t, self.chans[0]))))
        temb = torch.cat([temb] + [getattr(self, f"{name}_layer")(inputs[f"{name}_tensor"])
                                   for name, _ in self.embeddings], dim=1)
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


def follow(cfg: dict, work: dict, unet_state: dict, batches, draws, device, steps: int = 3,
           rows: int = 0, mode=None) -> dict:
    """Follow the first ``steps`` training steps (latent batch k, in the
    loader's (B, *spatial, C) layout, and draws k at step k) from the given
    weights; ``mode`` "fp8" computes the control. Draw k holds ``t``,
    ``noise`` (B, *spatial, C) and ``cond`` ({name: (B, n)})."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with nets.precision(mode):
            return _follow(cfg, work, unet_state, batches, draws, device, steps, rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _nc(t):
    return t.movedim(-1, 1)


def _follow(cfg, work, unet_state, batches, draws, device, steps, rows):
    unet = ldm.load(UNet(cfg["ddpm_params"]), {k: v.clone() for k, v in unet_state.items()})
    B = work["batch"]
    rows = rows or B
    sq_a, sq_s = ldm.schedule(cfg["time_scheduler_params"], device)
    scale = float(1.0 / torch.as_tensor(batches[0], device=device).std())
    params = list(unet.parameters())
    opt = ldm.AdamW(params, float(cfg.get("ddpm_learning_rate", 2e-5)),
                    float(cfg.get("grad_clip_max_norm", 1.0)),
                    float(cfg.get("ddpm_weight_decay", ldm.DECAY)))
    losses, clip_scale, grad0, grad_norm = [], None, None, None
    for k in range(steps):
        d = draws[k]
        z = _nc(torch.as_tensor(batches[k], device=device)) * scale
        t = d["t"].to(device)
        n_el = z.numel()
        loss = torch.zeros((), device=device)
        for r in range(0, B, rows):
            sl = slice(r, r + rows)
            ts = t[sl]
            a = sq_a[ts].reshape(-1, *[1] * (z.dim() - 1))
            s = sq_s[ts].reshape(-1, *[1] * (z.dim() - 1))
            noise = _nc(d["noise"][sl].to(device))
            noisy = a * z[sl] + s * noise
            cond = {f"{name}_tensor": c[sl].to(device).float() for name, c in d["cond"].items()}
            part = ((unet(noisy, ts, **cond) - noise) ** 2).sum() / n_el
            part.backward()
            loss += part.detach()
        grads = [p.grad for p in params]
        factor = opt.step(grads)
        if k == 0:
            clip_scale, grad0 = factor, [g.clone() for g in grads]
            grad_norm = opt.last_norm
        for p in params:
            p.grad = None
        losses.append(loss)
    with torch.no_grad():
        delta = [p - unet_state[n] for n, p in unet.named_parameters()]
    names = [n for n, _ in unet.named_parameters()]
    on_t = unet.timestep_leaves()
    return dict(names=names, timestep=[n in on_t for n in names], scale=scale,
                losses=torch.stack(losses).tolist(), grad_scale=clip_scale, grad0=grad0,
                grad_norm=grad_norm, delta=delta)
