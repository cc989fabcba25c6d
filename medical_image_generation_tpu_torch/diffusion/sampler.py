"""Diffusion samplers as plain Python loops over the model.

Port of ``medical_image_generation_tpu/diffusion/sampler.py``. The JAX
package compiles each trajectory into ``lax.scan`` segments; PyTorch runs
eagerly, so here a trajectory is a host loop that launches one model call per
step. The timestep ladders and the update rules are the reference's.

Random draws: the initial ``x_T`` and the per-step noise can be passed in as
tensors (tests feed the JAX package's draws); otherwise they come from the
caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from medical_image_generation_tpu_torch.diffusion.schedule import NoiseSchedule

# model_fn: (x_t, t_batch) -> model output, same shape as x_t
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _initial(shape, x_T, generator, device):
    if x_T is not None:
        if tuple(x_T.shape) != tuple(shape):
            raise ValueError(f"x_T shape {tuple(x_T.shape)} != {tuple(shape)}")
        return x_T.to(device=device, dtype=torch.float32)
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)


def _noise(i, like, noises, generator):
    if noises is not None:
        return noises[i].to(device=like.device, dtype=like.dtype)
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=like.dtype)


class DDIMSampler:
    """DDIM over the strided ladder ``arange(T-1, -1, -step)`` with
    ``step = max(1, T // num_inference_steps)``; the last step goes to
    t_prev = -1."""

    def __init__(self, schedule: NoiseSchedule, num_inference_steps: int = 50,
                 eta: float = 0.0, clip_x0: bool = True):
        T = schedule.num_train_timesteps
        step = max(1, T // num_inference_steps)
        self.schedule = schedule
        self.eta = eta
        self.clip_x0 = clip_x0
        self.ts = list(range(T - 1, -1, -step))
        self.ts_prev = self.ts[1:] + [-1]
        self.n = len(self.ts)

    @torch.no_grad()
    def __call__(self, model_fn: ModelFn, shape: Sequence[int], *,
                 device: str | torch.device = "cpu",
                 generator: Optional[torch.Generator] = None,
                 x_T: Optional[torch.Tensor] = None,
                 noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        x = _initial(shape, x_T, generator, device)
        B = x.shape[0]
        for i, (t, tp) in enumerate(zip(self.ts, self.ts_prev)):
            t_b = torch.full((B,), t, dtype=torch.long, device=x.device)
            tp_b = torch.full((B,), tp, dtype=torch.long, device=x.device)
            out = model_fn(x, t_b)
            noise = _noise(i, x, noises, generator) if self.eta > 0 else None
            x = self.schedule.ddim_step(out, t_b, tp_b, x, eta=self.eta,
                                        noise=noise, clip_x0=self.clip_x0)
        return x


class SegmentedDDPMSampler:
    """Full ancestral sampling over all T train timesteps, T-1 down to 0.
    The JAX package splits the trajectory into compiled segments to stay
    under device execution limits; an eager loop needs no segments, and the
    name is kept so the counterpart is easy to find."""

    def __init__(self, schedule: NoiseSchedule, clip_x0: bool = True):
        self.schedule = schedule
        self.clip_x0 = clip_x0
        self.T = schedule.num_train_timesteps

    @torch.no_grad()
    def __call__(self, model_fn: ModelFn, shape: Sequence[int], *,
                 device: str | torch.device = "cpu",
                 generator: Optional[torch.Generator] = None,
                 x_T: Optional[torch.Tensor] = None,
                 noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``noises[i]`` is the draw of the i-th step (timestep T-1-i)."""
        x = _initial(shape, x_T, generator, device)
        B = x.shape[0]
        for i, t in enumerate(range(self.T - 1, -1, -1)):
            t_b = torch.full((B,), t, dtype=torch.long, device=x.device)
            out = model_fn(x, t_b)
            x = self.schedule.step(out, t_b, x, _noise(i, x, noises, generator),
                                   clip_x0=self.clip_x0)
        return x
