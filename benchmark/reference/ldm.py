"""The latent diffusion training step in plain float32 PyTorch, followed for
the first steps of a run: the frozen KL-VAE's latent probe and scale factor,
then for each step the augmentation with the given draws, the posterior
sample, the noising, the U-Net's epsilon loss, the clip by global norm and
AdamW (optax's ``adamw`` with the configuration's learning rate and decay
1e-2). TF32 is off for every product. Rows are taken ``rows`` at a time, the
gradients summed over the blocks, so a large batch fits after the program
has freed the card.

Returns what the output check reads: each step's loss, the first raw
gradient with its global norm and the factor the clip scaled it by, which
leaves carry the timestep, and the parameters' change after the last step.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nets
from benchmark.reference.augment import augment

B1, B2, EPS, DECAY = 0.9, 0.999, 1e-8, 1e-2


def schedule(p: dict, device):
    """(sqrt(acp), sqrt(1 - acp)) as fp32 tables, made in float64."""
    T, b0, b1 = p["num_train_timesteps"], p["beta_start"], p["beta_end"]
    if p["schedule"] in ("scaled_linear_beta", "scaled_linear"):
        betas = np.linspace(b0 ** 0.5, b1 ** 0.5, T) ** 2
    elif p["schedule"] in ("linear_beta", "linear"):
        betas = np.linspace(b0, b1, T)
    else:
        raise NotImplementedError(p["schedule"])
    if p.get("prediction_type", "epsilon") != "epsilon":
        raise NotImplementedError(p["prediction_type"])
    acp = np.cumprod(1.0 - betas)
    return (torch.as_tensor(np.sqrt(acp).astype(np.float32), device=device),
            torch.as_tensor(np.sqrt(1.0 - acp).astype(np.float32), device=device))


def models(cfg: dict):
    """(U-Net, KL-VAE) on the meta device."""
    return nets.UNet(cfg["ddpm_params"]), nets.AutoencoderKL(cfg["vae_params"])


def named_shapes(model):
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def load(model, state: dict):
    model.load_state_dict(state, assign=True, strict=True)
    return model


def _nc(t):
    return t.movedim(-1, 1)


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, weight_decay=decay))``
    in fp32 (``adam`` when ``decay`` is 0)."""

    def __init__(self, params, lr: float, clip: float, decay: float = DECAY):
        self.params, self.lr, self.clip, self.count = list(params), lr, clip, 0
        self.decay, self.last_norm = decay, None
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> float:
        """Returns the factor the clip scaled the gradient by; keeps the norm
        before the clip in ``last_norm``."""
        norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))
        self.last_norm = norm
        scale = self.clip / norm if norm >= self.clip else 1.0
        if scale != 1.0:
            grads = torch._foreach_mul(grads, scale)
        self.count += 1
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - B2)
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        if self.decay:
            torch._foreach_add_(upd, self.params, alpha=self.decay)
        torch._foreach_add_(self.params, upd, alpha=-self.lr)
        return scale


def follow(cfg: dict, work: dict, unet_state: dict, vae_state: dict, batches, draws,
           probe_gen: torch.Generator, device, steps: int = 3, rows: int = 0,
           mode=None) -> dict:
    """Follow the first ``steps`` training steps (batch k and draws k at step
    k) from the given weights; ``mode`` "fp8" computes the control."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with nets.precision(mode):
            return _follow(cfg, work, unet_state, vae_state, batches, draws, probe_gen,
                           device, steps, rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _follow(cfg, work, unet_state, vae_state, batches, draws, probe_gen, device, steps, rows):
    unet, vae = models(cfg)
    unet = load(unet, {k: v.clone() for k, v in unet_state.items()})
    vae = load(vae, vae_state).requires_grad_(False)
    aug = work["augment"]
    crop = tuple(aug["crop_to"])
    B = work["batch"]
    rows = rows or B
    sq_a, sq_s = schedule(cfg["time_scheduler_params"], device)

    with torch.no_grad():  # the latent probe: scale = 1 / std(z) of batch 0's centre crop
        x = torch.as_tensor(batches[0], device=device)
        x = x[(slice(None),) + tuple(slice((s - o) // 2, (s - o) // 2 + o)
                                     for s, o in zip(x.shape[1:-1], crop))]
        eps = torch.randn((B, *work["latent"]["spatial"], work["latent"]["channels"]),
                          generator=probe_gen, device=device)
        zs = []
        for r in range(0, B, rows):
            mu, sigma = vae.encode(_nc(x[r:r + rows].float()))
            zs.append(mu + sigma * _nc(eps[r:r + rows]))
        scale = float(1.0 / (torch.cat(zs).std(correction=0) + 1e-8))
        del x, zs

    params = list(unet.parameters())
    opt = AdamW(params, float(cfg.get("ddpm_learning_rate", 2e-5)),
                float(cfg.get("grad_clip_max_norm", 1.0)))
    losses, clip_scale, grad0, grad_norm = [], None, None, None
    for k in range(steps):
        d = draws[k]
        x = augment(torch.as_tensor(batches[k], device=device), d["augment"], aug)
        t = d["t"].to(device)
        n_el = B * int(np.prod(d["noise"].shape[1:]))
        loss = torch.zeros((), device=device)
        for r in range(0, B, rows):
            sl = slice(r, r + rows)
            with torch.no_grad():
                mu, sigma = vae.encode(_nc(x[sl]))
                z = (mu + sigma * _nc(d["eps"][sl].to(device))) * scale
                ts = t[sl]
                a = sq_a[ts].reshape(-1, *[1] * (z.dim() - 1))
                s = sq_s[ts].reshape(-1, *[1] * (z.dim() - 1))
                noise = _nc(d["noise"][sl].to(device))
                noisy = a * z + s * noise
            part = ((unet(noisy, ts) - noise) ** 2).sum() / n_el
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

