"""Sinusoidal timestep features (mirror of ``upscale_a_video_tpu/ops/embeddings.py``)."""

from __future__ import annotations

import math

import torch


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True, downscale_freq_shift: float = 0.0,
                           scale: float = 1.0, max_period: int = 10000) -> torch.Tensor:
    """timesteps: (B,) → (B, embedding_dim) float32."""
    assert timesteps.ndim == 1, "timesteps must be a 1-D batch of scalars"
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
