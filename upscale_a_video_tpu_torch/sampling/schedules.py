"""Diffusion beta tables (copy of ``upscale_a_video_tpu/sampling/schedules.py``):
small static numpy tables built once per scheduler."""

from __future__ import annotations

import math

import numpy as np


def betas_for_alpha_bar(num_diffusion_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(time_step: float) -> float:
        return math.cos((time_step + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.asarray(betas, dtype=np.float32)


def make_betas(beta_schedule: str, num_train_timesteps: int, beta_start: float,
               beta_end: float, trained_betas=None) -> np.ndarray:
    if trained_betas is not None:
        return np.asarray(trained_betas, dtype=np.float32)
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                           dtype=np.float32) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        return betas_for_alpha_bar(num_train_timesteps)
    raise NotImplementedError(f"unknown beta schedule: {beta_schedule!r}")
