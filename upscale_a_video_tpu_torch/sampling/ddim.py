"""DDIM scheduler with the split ``step_v0`` / ``step_vt`` API.

Mirror of ``upscale_a_video_tpu/sampling/ddim.py``. Timesteps are Python ints
(the port steps in a Python loop), so every coefficient is a float32 numpy
scalar computed on the host, in the reference's float32 arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .ddpm import add_noise
from .schedules import make_betas


@dataclasses.dataclass(frozen=True)
class DDIMSchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    trained_betas: Optional[tuple] = None
    clip_sample: bool = True
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "epsilon"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    clip_sample_range: float = 1.0
    sample_max_value: float = 1.0


class DDIMScheduler:
    def __init__(self, config: DDIMSchedulerConfig = DDIMSchedulerConfig()):
        self.config = config
        self.betas = make_betas(config.beta_schedule, config.num_train_timesteps,
                                config.beta_start, config.beta_end, config.trained_betas)
        self.alphas = 1.0 - self.betas
        self.alphas_cumprod = np.cumprod(self.alphas, dtype=np.float64).astype(np.float32)
        self.final_alpha_cumprod = (np.float32(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending integer grid (ref scheduling_ddim.py:237-259)."""
        if num_inference_steps > self.config.num_train_timesteps:
            raise ValueError("num_inference_steps > num_train_timesteps")
        ratio = self.config.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1].copy().astype(np.int64)
        return ts + self.config.steps_offset

    def _alphas(self, t: int, num_inference_steps: int):
        prev_t = int(t) - self.config.num_train_timesteps // num_inference_steps
        a_t = self.alphas_cumprod[int(t)]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        return np.float32(a_t), np.float32(a_prev)

    def _pred_x0_eps(self, model_output, sample, a_t):
        b_t = np.float32(1.0) - a_t
        pt = self.config.prediction_type
        if pt == "epsilon":
            return (sample - b_t ** 0.5 * model_output) / a_t ** 0.5, model_output
        if pt == "sample":
            return model_output, (sample - a_t ** 0.5 * model_output) / b_t ** 0.5
        if pt == "v_prediction":
            return (a_t ** 0.5 * sample - b_t ** 0.5 * model_output,
                    a_t ** 0.5 * model_output + b_t ** 0.5 * sample)
        raise ValueError(f"prediction_type must be epsilon|sample|v_prediction, got {pt}")

    def _threshold_sample(self, sample):
        cfg = self.config
        b = sample.shape[0]
        flat = sample.float().reshape(b, -1)
        s = torch.quantile(flat.abs(), cfg.dynamic_thresholding_ratio, dim=1)
        s = s.clamp(1.0, cfg.sample_max_value)[:, None]
        flat = torch.maximum(torch.minimum(flat, s), -s) / s
        return flat.reshape(sample.shape).to(sample.dtype)

    def _clip_or_threshold(self, x0):
        if self.config.thresholding:
            return self._threshold_sample(x0)
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            return x0.clamp(-r, r)
        return x0

    def _finish(self, x0, eps, sample, a_t, a_prev, eta, use_clipped_model_output,
                generator, variance_noise):
        b_t = np.float32(1.0) - a_t
        variance = (np.float32(1.0) - a_prev) / b_t * (np.float32(1.0) - a_t / a_prev)
        std = np.float32(eta) * variance ** 0.5
        if use_clipped_model_output:
            eps = (sample - a_t ** 0.5 * x0) / b_t ** 0.5
        prev = a_prev ** 0.5 * x0 + (np.float32(1.0) - a_prev - std ** 2) ** 0.5 * eps
        if eta > 0:
            if variance_noise is None:
                if generator is None:
                    raise ValueError("eta > 0 requires a `generator` or `variance_noise`")
                variance_noise = torch.randn(eps.shape, generator=generator,
                                             device=eps.device, dtype=eps.dtype)
            prev = prev + std * variance_noise
        return prev

    def step(self, model_output, timestep, sample, num_inference_steps: int,
             eta: float = 0.0, use_clipped_model_output: bool = False,
             generator: Optional[torch.Generator] = None, variance_noise=None):
        """Fused x_t → x_{t-1}; returns ``(prev_sample, pred_original_sample)``."""
        a_t, a_prev = self._alphas(timestep, num_inference_steps)
        x0, eps = self._pred_x0_eps(model_output, sample, a_t)
        x0 = self._clip_or_threshold(x0)
        prev = self._finish(x0, eps, sample, a_t, a_prev, eta, use_clipped_model_output,
                            generator, variance_noise)
        return prev, x0

    def step_v0(self, model_output, timestep, sample):
        """First half of the split step: the clipped x̂0."""
        a_t = np.float32(self.alphas_cumprod[int(timestep)])
        x0, _ = self._pred_x0_eps(model_output, sample, a_t)
        return self._clip_or_threshold(x0)

    def step_vt(self, v0, model_output, timestep, sample, num_inference_steps: int,
                eta: float = 0.0, use_clipped_model_output: bool = False,
                generator: Optional[torch.Generator] = None, variance_noise=None):
        """Second half: finish DDIM from an external x̂0. As the reference does,
        ε̂ comes from the raw model output under epsilon prediction and x̂0 is
        clipped again (docs/PARITY.md, replicated quirks)."""
        a_t, a_prev = self._alphas(timestep, num_inference_steps)
        b_t = np.float32(1.0) - a_t
        pt = self.config.prediction_type
        if pt == "epsilon":
            eps = model_output
        elif pt == "sample":
            eps = (sample - a_t ** 0.5 * v0) / b_t ** 0.5
        elif pt == "v_prediction":
            eps = a_t ** 0.5 * model_output + b_t ** 0.5 * sample
        else:
            raise ValueError(f"unknown prediction_type {pt}")
        x0 = self._clip_or_threshold(v0)
        return self._finish(x0, eps, sample, a_t, a_prev, eta, use_clipped_model_output,
                            generator, variance_noise)

    def add_noise(self, original_samples, noise, timesteps):
        return add_noise(self.alphas_cumprod, original_samples, noise, timesteps)

    def get_velocity(self, sample, noise, timesteps):
        acp = torch.as_tensor(self.alphas_cumprod, dtype=sample.dtype, device=sample.device)
        t = torch.as_tensor(timesteps, device=sample.device).reshape(-1).long()
        shape = (t.shape[0],) + (1,) * (sample.ndim - 1)
        return ((acp[t] ** 0.5).reshape(shape) * noise
                - ((1.0 - acp[t]) ** 0.5).reshape(shape) * sample)

    def __len__(self) -> int:
        return self.config.num_train_timesteps
