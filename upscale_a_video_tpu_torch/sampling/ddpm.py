"""DDPM scheduler: the pipeline's ``low_res_scheduler``, which only noises the
LR frames (``add_noise``), plus the ancestral ``step``. Mirror of
``upscale_a_video_tpu/sampling/ddpm.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .schedules import make_betas


@dataclasses.dataclass(frozen=True)
class DDPMSchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "scaled_linear"
    trained_betas: Optional[tuple] = None
    variance_type: str = "fixed_small"
    clip_sample: bool = True
    prediction_type: str = "epsilon"
    clip_sample_range: float = 1.0


def add_noise(alphas_cumprod: np.ndarray, original: torch.Tensor,
              noise: torch.Tensor, timesteps) -> torch.Tensor:
    """q(x_t | x_0) with per-batch timesteps broadcast over trailing axes."""
    acp = torch.as_tensor(alphas_cumprod, dtype=original.dtype, device=original.device)
    t = torch.as_tensor(timesteps, device=original.device).reshape(-1).long()
    shape = (t.shape[0],) + (1,) * (original.ndim - 1)
    sqrt_ap = (acp[t] ** 0.5).reshape(shape)
    sqrt_omap = ((1.0 - acp[t]) ** 0.5).reshape(shape)
    return sqrt_ap * original + sqrt_omap * noise


class DDPMScheduler:
    def __init__(self, config: DDPMSchedulerConfig = DDPMSchedulerConfig()):
        self.config = config
        self.betas = make_betas(config.beta_schedule, config.num_train_timesteps,
                                config.beta_start, config.beta_end, config.trained_betas)
        self.alphas = 1.0 - self.betas
        self.alphas_cumprod = np.cumprod(self.alphas, dtype=np.float64).astype(np.float32)
        self.init_noise_sigma = 1.0

    def add_noise(self, original_samples, noise, timesteps):
        return add_noise(self.alphas_cumprod, original_samples, noise, timesteps)

    def step(self, model_output, timestep: int, sample, noise=None):
        """One ancestral step x_t → x_{t-1}; returns ``(prev_sample, x̂0)``.
        ``noise`` (the same shape as ``sample``) adds the posterior variance."""
        cfg = self.config
        t = int(timestep)
        a_t = np.float32(self.alphas_cumprod[t])
        a_prev = np.float32(self.alphas_cumprod[t - 1]) if t > 0 else np.float32(1.0)
        b_t, b_prev = np.float32(1.0) - a_t, np.float32(1.0) - a_prev
        cur_a = a_t / a_prev
        cur_b = np.float32(1.0) - cur_a
        if cfg.prediction_type == "epsilon":
            x0 = (sample - b_t ** 0.5 * model_output) / a_t ** 0.5
        elif cfg.prediction_type == "sample":
            x0 = model_output
        elif cfg.prediction_type == "v_prediction":
            x0 = a_t ** 0.5 * sample - b_t ** 0.5 * model_output
        else:
            raise ValueError(f"unknown prediction_type {cfg.prediction_type}")
        if cfg.clip_sample:
            x0 = x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)
        mean = (a_prev ** 0.5 * cur_b / b_t) * x0 + (cur_a ** 0.5 * b_prev / b_t) * sample
        if noise is None or t == 0:
            return mean, x0
        var = cur_b if cfg.variance_type == "fixed_large" else max(b_prev / b_t * cur_b,
                                                                   np.float32(1e-20))
        return mean + np.float32(var) ** 0.5 * noise, x0

    def __len__(self) -> int:
        return self.config.num_train_timesteps
