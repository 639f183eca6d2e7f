"""Optical-flow visualization (color wheel), ref RAFT/utils/flow_viz.py.

A copy of ``upscale_a_video_tpu/utils/flow_viz.py`` (numpy only), kept here
so the port imports nothing of the JAX package: the standard Middlebury
color wheel (Baker et al.) — host-side debug tooling, not a device op.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """(55, 3) RGB color wheel."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8 color-wheel visualization."""
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-5)
    u = u / rad_max
    v = v / rad_max
    rad = rad / rad_max

    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), dtype=np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # saturate with radius
        img[..., i] = np.floor(255 * col)
    return img


class InputPadder:
    """Pads arrays so spatial dims are divisible by 8 (ref RAFT/utils/utils.py:7-24).
    Channels-last: (..., H, W, C)."""

    def __init__(self, h: int, w: int, mode: str = "sintel"):
        pad_h = (((h // 8) + 1) * 8 - h) % 8
        pad_w = (((w // 8) + 1) * 8 - w) % 8
        if mode == "sintel":
            self._pad = (pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2)
        else:
            self._pad = (0, pad_h, pad_w // 2, pad_w - pad_w // 2)

    def pad(self, *arrays):
        t, b, l, r = self._pad
        return [
            np.pad(a, [(0, 0)] * (a.ndim - 3) + [(t, b), (l, r), (0, 0)],
                   mode="edge")
            for a in arrays
        ]

    def unpad(self, x):
        t, b, l, r = self._pad
        h, w = x.shape[-3], x.shape[-2]
        return x[..., t: h - b, l: w - r, :]
