"""Rotary position embedding, interleaved pairs on the first ``rot_dim``
channels (mirror of ``upscale_a_video_tpu/ops/rope.py``)."""

from __future__ import annotations

import torch


def rotary_tables(seq: int, rot_dim: int, theta: float = 10000.0, device=None):
    """(seq, rot_dim//2) float32 cos and sin; pair i turns at theta^(-2i/rot_dim)."""
    freqs = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                          device=device) / rot_dim))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(t: torch.Tensor, rot_dim: int, theta: float = 10000.0,
                 seq_axis: int = -2) -> torch.Tensor:
    """Rotate the first ``rot_dim`` channels of ``t`` by the position along
    ``seq_axis`` (-2 for (..., S, D), -3 for (..., S, H, D))."""
    d = t.shape[-1]
    assert d >= rot_dim, f"head dim {d} < rot_dim {rot_dim}"
    seq_axis = seq_axis if seq_axis < 0 else seq_axis - t.ndim
    assert seq_axis in (-2, -3)
    cos, sin = rotary_tables(t.shape[seq_axis], rot_dim, theta, t.device)
    cos = cos.repeat_interleave(2, dim=-1)
    sin = sin.repeat_interleave(2, dim=-1)
    if seq_axis == -3:
        cos, sin = cos[:, None, :], sin[:, None, :]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    x = t_rot.reshape(*t_rot.shape[:-1], rot_dim // 2, 2)
    rotated = torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(t_rot.shape)
    out = t_rot.float() * cos + rotated.float() * sin
    return torch.cat([out.to(t.dtype), t_pass], dim=-1)
