"""Temporal sliding windows (copy of ``upscale_a_video_tpu/pipeline/windows.py``).

The reference runs the UNet on 8-frame windows with stride 6, right-aligns
the last window (which can repeat a start: T=14 gives 0, 6, 6) and blends
overlaps with a sequential 0.5/0.5 running average. The blend matrix below
reproduces that average in one weighted sum; ``unique_window_plan`` runs each
repeated window once and sums its weights, which gives the same output.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np


@functools.lru_cache(maxsize=128)
def window_starts(num_frames: int, window: int = 8, stride: int = 6) -> Tuple[int, ...]:
    if num_frames <= window:
        return (0,)
    starts = []
    for start in range(0, num_frames, stride):
        end = min(num_frames, start + window)
        if end - start < window:
            start = end - window
        starts.append(start)
    return tuple(starts)


@functools.lru_cache(maxsize=128)
def window_blend_matrix(num_frames: int, window: int = 8, stride: int = 6) -> np.ndarray:
    """(num_windows, window, num_frames) M with out[t] = Σ_{n,k} M[n,k,t]·pred[n][k]."""
    starts = window_starts(num_frames, window, stride)
    win = min(window, num_frames)
    cover: List[List[Tuple[int, int]]] = [[] for _ in range(num_frames)]
    for n, s in enumerate(starts):
        for k in range(win):
            cover[s + k].append((n, k))
    m = np.zeros((len(starts), win, num_frames), dtype=np.float32)
    for t, entries in enumerate(cover):
        kk = len(entries)
        for i, (n, k) in enumerate(entries, start=1):
            m[n, k, t] = 1.0 if kk == 1 else (0.5 ** (kk - 1) if i == 1 else 0.5 ** (kk - i + 1))
    assert np.allclose(m.sum(axis=(0, 1)), 1.0)
    return m


@functools.lru_cache(maxsize=128)
def chunk_starts(num_frames: int, chunk: int) -> Tuple[Tuple[int, int], ...]:
    """(start, end) decode chunks (ref pipeline_upscale_a_video.py:685-700)."""
    if num_frames <= chunk:
        return ((0, num_frames),)
    return tuple((s, min(num_frames, s + chunk)) for s in range(0, num_frames, chunk))


@functools.lru_cache(maxsize=128)
def unique_window_plan(num_frames: int, window: int = 8, stride: int = 6
                       ) -> Tuple[Tuple[int, ...], np.ndarray]:
    """(unique starts, blend) with repeated windows collapsed."""
    starts = window_starts(num_frames, window, stride)
    full = window_blend_matrix(num_frames, window, stride)
    unique: List[int] = []
    for s in starts:
        if s not in unique:
            unique.append(s)
    blend = np.zeros((len(unique),) + full.shape[1:], dtype=np.float32)
    for n, s in enumerate(starts):
        blend[unique.index(s)] += full[n]
    assert np.allclose(blend.sum(axis=(0, 1)), 1.0)
    return tuple(unique), blend
