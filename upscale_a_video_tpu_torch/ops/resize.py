"""Bicubic resizing of channels-last frames as two matrix products.

Mirror of the bicubic mode of ``upscale_a_video_tpu/ops/resize.py``
(``resize_2d`` at ``:105``), the mode the colour fix uses: the 1-D
resampling matrices are built in numpy with torch's ``F.interpolate``
semantics (Keys kernel with a = -0.75, half-pixel centres, border
replicate) and applied with two fp32 einsums.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    out = np.zeros_like(ax)
    m1 = ax <= 1
    m2 = (ax > 1) & (ax < 2)
    out[m1] = (a + 2) * ax[m1] ** 3 - (a + 3) * ax[m1] ** 2 + 1
    out[m2] = a * ax[m2] ** 3 - 5 * a * ax[m2] ** 2 + 8 * a * ax[m2] - 4 * a
    return out


@functools.lru_cache(maxsize=512)
def weight_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) float32 bicubic resampling matrix of one axis."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    for tap in range(-1, 3):
        idx = np.clip(lo + tap, 0, in_size - 1)
        np.add.at(w, (np.arange(out_size), idx), _cubic_kernel(tap - frac))
    return w.astype(np.float32)


def resize_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of the (-3, -2) spatial axes of a channels-last tensor:
    (..., H, W, C) → (..., out_h, out_w, C), same dtype, fp32 arithmetic."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    wh = torch.as_tensor(weight_matrix(oh, h), device=x.device)
    ww = torch.as_tensor(weight_matrix(ow, w), device=x.device)
    y = torch.einsum("Hh,...hwc->...Hwc", wh, x.float())
    y = torch.einsum("Ww,...hwc->...hWc", ww, y)
    return y.to(x.dtype)
