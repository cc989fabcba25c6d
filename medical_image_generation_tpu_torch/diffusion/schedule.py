"""DDPM noise schedule: tables built in float64, stored as fp32 tensors.

Port of ``medical_image_generation_tpu/diffusion/schedule.py``: the same
``make_betas`` ramps, the same fp32 tables, and the same closed-form
``pred_x0`` / ancestral ``step`` / ``ddim_step``. Random draws are passed in
as tensors, never drawn here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def make_betas(
    num_train_timesteps: int,
    schedule: str = "scaled_linear_beta",
    beta_start: float = 0.0015,
    beta_end: float = 0.0205,
) -> np.ndarray:
    if schedule in ("linear_beta", "linear"):
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
    elif schedule in ("scaled_linear_beta", "scaled_linear"):
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
    elif schedule == "cosine":
        s = 0.008
        steps = np.arange(num_train_timesteps + 1, dtype=np.float64)
        f = np.cos(((steps / num_train_timesteps) + s) / (1 + s) * np.pi / 2) ** 2
        alphas_cumprod = f / f[0]
        betas = np.clip(1 - alphas_cumprod[1:] / alphas_cumprod[:-1], 0, 0.999)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return betas.astype(np.float64)


@dataclass(frozen=True)
class NoiseSchedule:
    """Immutable fp32 schedule tables on one device. Build with ``create``."""

    num_train_timesteps: int
    prediction_type: str
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor

    @staticmethod
    def create(
        num_train_timesteps: int = 1000,
        schedule: str = "scaled_linear_beta",
        beta_start: float = 0.0015,
        beta_end: float = 0.0205,
        prediction_type: str = "epsilon",
        device: str | torch.device = "cpu",
    ) -> "NoiseSchedule":
        if prediction_type not in ("epsilon", "v_prediction", "sample"):
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        betas = make_betas(num_train_timesteps, schedule, beta_start, beta_end)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return NoiseSchedule(
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
            betas=t32(betas),
            alphas=t32(alphas),
            alphas_cumprod=t32(acp),
            sqrt_alphas_cumprod=t32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=t32(np.sqrt(1 - acp)),
        )

    @staticmethod
    def from_config(params: dict, device: str | torch.device = "cpu") -> "NoiseSchedule":
        """Build from the planner's ``time_scheduler_params`` dict."""
        return NoiseSchedule.create(
            num_train_timesteps=params.get("num_train_timesteps", 1000),
            schedule=params.get("schedule", "scaled_linear_beta"),
            beta_start=params.get("beta_start", 0.0015),
            beta_end=params.get("beta_end", 0.0205),
            prediction_type=params.get("prediction_type", "epsilon"),
            device=device,
        )

    @staticmethod
    def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
        return v.reshape(v.shape + (1,) * (ndim - v.ndim))

    def _gather(self, table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return self._bcast(table[t], ndim)

    def pred_x0(self, model_out, x_t, t):
        """Recover x0 from the model output under the prediction type."""
        a = self._gather(self.sqrt_alphas_cumprod, t, x_t.ndim)
        s = self._gather(self.sqrt_one_minus_alphas_cumprod, t, x_t.ndim)
        if self.prediction_type == "epsilon":
            return (x_t - s * model_out) / a
        if self.prediction_type == "v_prediction":
            return a * x_t - s * model_out
        return model_out

    def step(self, model_out, t, x_t, noise, clip_x0: bool = True):
        """One ancestral DDPM step x_t -> x_{t-1}; ``noise`` is applied only
        where t > 0."""
        x0 = self.pred_x0(model_out, x_t, t)
        if clip_x0:
            x0 = x0.clamp(-1.0, 1.0)
        nd = x_t.ndim
        acp_t = self._gather(self.alphas_cumprod, t, nd)
        prev_t = (t - 1).clamp(min=0)
        one = torch.ones((), dtype=acp_t.dtype, device=acp_t.device)
        acp_prev = self._bcast(torch.where(t > 0, self.alphas_cumprod[prev_t], one), nd)
        beta_t = self._gather(self.betas, t, nd)
        alpha_t = self._gather(self.alphas, t, nd)
        coef_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
        coef_xt = torch.sqrt(alpha_t) * (1.0 - acp_prev) / (1.0 - acp_t)
        mean = coef_x0 * x0 + coef_xt * x_t
        var = ((1.0 - acp_prev) / (1.0 - acp_t) * beta_t).clamp(min=1e-20)
        nonzero = self._bcast((t > 0).to(x_t.dtype), nd)
        return mean + nonzero * torch.sqrt(var) * noise

    def ddim_step(self, model_out, t, t_prev, x_t, eta: float = 0.0,
                  noise=None, clip_x0: bool = True):
        """One DDIM step x_t -> x_{t_prev} (t_prev = -1 means the end, where
        alpha_cumprod is taken as 1); deterministic at eta = 0."""
        x0 = self.pred_x0(model_out, x_t, t)
        if clip_x0:
            x0 = x0.clamp(-1.0, 1.0)
        nd = x_t.ndim
        acp_t = self._gather(self.alphas_cumprod, t, nd)
        one = torch.ones((), dtype=acp_t.dtype, device=acp_t.device)
        acp_prev = self._bcast(
            torch.where(t_prev >= 0, self.alphas_cumprod[t_prev.clamp(min=0)], one), nd)
        eps = (x_t - torch.sqrt(acp_t) * x0) / torch.sqrt(1.0 - acp_t)
        sigma = eta * torch.sqrt((1 - acp_prev) / (1 - acp_t) * (1 - acp_t / acp_prev))
        dir_xt = torch.sqrt((1.0 - acp_prev - sigma**2).clamp(min=0.0)) * eps
        x_prev = torch.sqrt(acp_prev) * x0 + dir_xt
        if eta > 0 and noise is not None:
            x_prev = x_prev + sigma * noise
        return x_prev
