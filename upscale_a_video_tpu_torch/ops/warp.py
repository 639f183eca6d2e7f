"""Grid sampling and flow warping of channels-last tensors.

Mirror of ``upscale_a_video_tpu/ops/warp.py`` (``grid_sample`` at ``:28``,
``flow_warp`` at ``:88``). The JAX version is a gather written to reproduce
``F.grid_sample``; no Pallas kernel serves it, so the port calls
``F.grid_sample`` itself on an NCHW view: ``zeros`` or ``border`` padding,
bilinear or nearest (round half to even) taps, both ``align_corners``
conventions, grid last axis (x, y) normalised to [-1, 1]. Arithmetic in
float32 (float64 for float64 inputs), the result in the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def compute_dtype(*ts: torch.Tensor) -> torch.dtype:
    """float32, or float64 when an input is float64."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) else torch.float32


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """x: (B, H, W, C); grid: (B, Hg, Wg, 2) with (x, y) in [-1, 1]
    → (B, Hg, Wg, C)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r}")
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"mode {mode!r}")
    dt = compute_dtype(x, grid)
    out = F.grid_sample(x.to(dt).permute(0, 3, 1, 2), grid.to(dt), mode=mode,
                        padding_mode=padding_mode, align_corners=align_corners)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interpolation: str = "bilinear",
              padding_mode: str = "zeros", align_corners: bool = True) -> torch.Tensor:
    """Warp ``x`` (B, H, W, C) by the pixel offsets ``flow`` (B, H, W, 2),
    (x, y) last: output pixel (i, j) samples x at (j + flow_x, i + flow_y)."""
    b, h, w, _ = x.shape
    if tuple(flow.shape[1:3]) != (h, w):
        raise ValueError(f"flow spatial {tuple(flow.shape)} != input {tuple(x.shape)}")
    dt = compute_dtype(x, flow)
    yy = torch.arange(h, dtype=dt, device=x.device)[:, None]
    xx = torch.arange(w, dtype=dt, device=x.device)[None, :]
    gx = xx + flow[..., 0].to(dt)
    gy = yy + flow[..., 1].to(dt)
    grid = torch.stack([2.0 * gx / max(w - 1, 1) - 1.0, 2.0 * gy / max(h - 1, 1) - 1.0], dim=-1)
    return grid_sample(x, grid, mode=interpolation, padding_mode=padding_mode,
                       align_corners=align_corners)
