"""Grid sampling and flow warping of channels-last tensors.

Mirror of ``upscale_a_video_tpu/ops/warp.py`` (``grid_sample`` at ``:28``,
``flow_warp`` at ``:88``). The JAX version is a gather written to reproduce
``F.grid_sample``; no Pallas kernel serves it, so the port calls
``F.grid_sample`` itself on an NCHW view: ``zeros`` or ``border`` padding,
bilinear or nearest (round half to even) taps, both ``align_corners``
conventions, grid last axis (x, y) normalised to [-1, 1]. Arithmetic in
float32, the result in the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """x: (B, H, W, C); grid: (B, Hg, Wg, 2) with (x, y) in [-1, 1]
    → (B, Hg, Wg, C)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r}")
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"mode {mode!r}")
    out = F.grid_sample(x.float().permute(0, 3, 1, 2), grid.float(), mode=mode,
                        padding_mode=padding_mode, align_corners=align_corners)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interpolation: str = "bilinear",
              padding_mode: str = "zeros", align_corners: bool = True) -> torch.Tensor:
    """Warp ``x`` (B, H, W, C) by the pixel offsets ``flow`` (B, H, W, 2),
    (x, y) last: output pixel (i, j) samples x at (j + flow_x, i + flow_y)."""
    b, h, w, _ = x.shape
    if tuple(flow.shape[1:3]) != (h, w):
        raise ValueError(f"flow spatial {tuple(flow.shape)} != input {tuple(x.shape)}")
    yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    gx = xx + flow[..., 0].float()
    gy = yy + flow[..., 1].float()
    grid = torch.stack([2.0 * gx / max(w - 1, 1) - 1.0, 2.0 * gy / max(h - 1, 1) - 1.0], dim=-1)
    return grid_sample(x, grid, mode=interpolation, padding_mode=padding_mode,
                       align_corners=align_corners)
