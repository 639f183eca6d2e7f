"""Separable resizing of channels-last frames as two matrix products.

Mirror of ``upscale_a_video_tpu/ops/resize.py`` (``resize_2d`` at ``:105``):
the 1-D resampling matrices are built in numpy with torch's
``F.interpolate`` semantics and applied with two fp32 einsums.

- ``nearest``: src = floor(i * in / out)
- ``bilinear`` (align_corners=False): half-pixel centres; (True): src =
  i * (in - 1) / (out - 1)
- ``bicubic``: Keys kernel with a = -0.75, border replicate (the colour fix)
- ``area``: adaptive average pooling, applied even at equal size

Callers: the colour fix (bicubic), RAFT (bilinear, both ``align_corners``)
and the propagation's flow resize (area).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _nearest_matrix(out_size: int, in_size: int) -> np.ndarray:
    w = np.zeros((out_size, in_size), dtype=np.float32)
    src = (np.arange(out_size) * in_size // out_size).clip(0, in_size - 1)
    w[np.arange(out_size), src] = 1.0
    return w


def _linear_matrix(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    w = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1 and (align_corners or in_size == 1):
        w[0, 0] = 1.0
        return w.astype(np.float32)
    if align_corners and out_size > 1:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    w[np.arange(out_size), lo] += 1 - frac
    w[np.arange(out_size), hi] += frac
    return w.astype(np.float32)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    out = np.zeros_like(ax)
    m1 = ax <= 1
    m2 = (ax > 1) & (ax < 2)
    out[m1] = (a + 2) * ax[m1] ** 3 - (a + 3) * ax[m1] ** 2 + 1
    out[m2] = a * ax[m2] ** 3 - 5 * a * ax[m2] ** 2 + 8 * a * ax[m2] - 4 * a
    return out


def _cubic_matrix(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    w = np.zeros((out_size, in_size), dtype=np.float64)
    if align_corners and out_size > 1:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    for tap in range(-1, 3):
        idx = np.clip(lo + tap, 0, in_size - 1)
        np.add.at(w, (np.arange(out_size), idx), _cubic_kernel(tap - frac))
    return w.astype(np.float32)


def _area_matrix(out_size: int, in_size: int) -> np.ndarray:
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        start = int(np.floor(i * in_size / out_size))
        end = int(np.ceil((i + 1) * in_size / out_size))
        w[i, start:end] = 1.0 / (end - start)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=512)
def weight_matrix(out_size: int, in_size: int, method: str = "bicubic",
                  align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) float32 resampling matrix of one axis."""
    if out_size == in_size and method != "area":
        return np.eye(out_size, dtype=np.float32)
    if method == "nearest":
        return _nearest_matrix(out_size, in_size)
    if method == "bilinear":
        return _linear_matrix(out_size, in_size, align_corners)
    if method == "bicubic":
        return _cubic_matrix(out_size, in_size, align_corners)
    if method == "area":
        return _area_matrix(out_size, in_size)
    raise ValueError(f"unknown resize method {method!r}")


def resize_2d(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "bicubic",
              align_corners: bool = False) -> torch.Tensor:
    """Resize the (-3, -2) spatial axes of a channels-last tensor:
    (..., H, W, C) → (..., out_h, out_w, C), same dtype, fp32 arithmetic."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (oh, ow) == (h, w) and method != "area":
        return x
    wh = torch.as_tensor(weight_matrix(oh, h, method, align_corners), device=x.device)
    ww = torch.as_tensor(weight_matrix(ow, w, method, align_corners), device=x.device)
    y = torch.einsum("Hh,...hwc->...Hwc", wh, x.float())
    y = torch.einsum("Ww,...hwc->...hWc", ww, y)
    return y.to(x.dtype)
