"""Temporal-chunk parallelism: the frame axis split across ranks (port of
``upscale_a_video_tpu/parallel/temporal.py``).

The reference scales the frame count by serial 8-frame windows (stride 6,
overlap 2, averaged; ref pipeline_upscale_a_video.py:601-635). Here the same
computation is spread over ranks, each owning a chunk of ``T_local`` frames
(a multiple of the stride):

- windows starting in a chunk are computed by its rank; the last window of
  each chunk but the last spills ``window - stride`` frames into the right
  neighbour's chunk, so each rank first receives the first ``window -
  stride`` frames of its right neighbour (the halo);
- the spilled predictions go right (a paired send and receive), and the
  receiving rank applies the reference's sequential 0.5/0.5 blend, its own
  first window being the later contribution, as in the serial order;
- the last chunk right-aligns its last window itself.

The plan equals the reference's when ``T_local % stride == 0`` and the
chunks tile T; one chunk is the serial plan and exchanges nothing.
:func:`windowed_apply_local` runs on a rank's chunk (the sharded denoise,
``sharded_pipeline.py``, steps around it); :func:`sharded_windowed_apply`
wraps it for a whole clip given to every rank. Inputs may be a tuple of
tensors sharing the frame axis (latents and LR frames).
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import all_gather, axis_group, ppermute


def local_window_count(t_local: int, n_chunks: int, window: int = 8, stride: int = 6) -> int:
    """Windows each rank computes (the same on every rank and step): the
    length of the per-window cache list :func:`windowed_apply_local` takes."""
    if n_chunks == 1:
        # as the loop below: it stops only after a right-aligned window
        # (s + window > t); at s + window == t the reference's range goes on
        # and blends a repeated right-aligned window (ref :621-634 has no break)
        n = 0
        for s in range(0, t_local, stride):
            n += 1
            if s + window > t_local:
                break
        return n
    full = len([s for s in range(0, t_local, stride) if s + window <= t_local])
    return full + 1  # + the spill or right-aligned window


def _map(fn, xs):
    return tuple(fn(x) for x in xs) if isinstance(xs, (tuple, list)) else fn(xs)


def _first(xs) -> torch.Tensor:
    return xs[0] if isinstance(xs, (tuple, list)) else xs


def _blend(out, cover, pred, start: int, window: int):
    """The sequential 0.5/0.5 average of ``pred`` into ``out[:, start:start +
    window]`` where ``cover`` marks frames already written."""
    seg, cov = out[:, start:start + window], cover[:, start:start + window]
    out[:, start:start + window] = torch.where(cov > 0, 0.5 * seg + 0.5 * pred, pred)
    cover[:, start:start + window] = 1.0


def windowed_apply_local(fn: Callable, xs, n_chunks: int, window: int = 8, stride: int = 6,
                         caches=None, group=None, rank: int = 0):
    """Run ``fn`` over the temporal windows of this rank's chunk with the
    reference's overlap averaging. ``xs``: a (B, T_local, ...) tensor or a
    tuple of them; ``fn``: such windows (B, window, ...) → (B, window, ...).
    ``group`` and ``rank`` are the ranks the frame axis is split over and
    this rank's index among them (``mesh.axis_group``); every rank of the
    group calls this with the same shapes.

    With ``caches`` (one per local window in plan order, see
    :func:`local_window_count`), ``fn(xs_w, cache)`` returns ``(pred,
    new_cache)`` and the call returns ``(out, new_caches)``. Each global
    window is computed by exactly one rank, so per-window caches (PAB's
    attention deltas) stay on that rank across steps."""
    overlap = window - stride
    b, t_local = _first(xs).shape[:2]
    if not (t_local % stride == 0 and t_local >= window):
        raise ValueError(f"T_local={t_local} must be a multiple of the stride {stride} and "
                         f">= the window {window}")
    new_caches = []

    def call(xs_w, wi):
        if caches is None:
            return fn(xs_w)
        pred, nc = fn(xs_w, caches[wi])
        new_caches.append(nc)
        return pred

    def done(out):
        return (out, new_caches) if caches is not None else out

    def buffers(pred, t):
        return (pred.new_zeros((b, t) + tuple(pred.shape[2:])),
                pred.new_zeros((b, t) + (1,) * (pred.dim() - 2)))

    if n_chunks == 1:  # the serial plan (exactly the reference loop)
        out = cover = None
        for wi, s in enumerate(range(0, t_local, stride)):
            a, e = (s, s + window) if s + window <= t_local else (t_local - window, t_local)
            pred = call(_map(lambda x: x[:, a:e], xs), wi)
            if out is None:
                out, cover = buffers(pred, t_local)
            _blend(out, cover, pred, a, window)
            if e == t_local and s + window > t_local:
                break
        return done(out)

    # several chunks: the right neighbour's first frames, the local and the
    # spill windows, then the spill to the right neighbour
    left = [(i, (i - 1) % n_chunks) for i in range(n_chunks)]
    xs_ext = _map(lambda x: torch.cat([x, ppermute(x[:, :overlap], left, group, rank)], 1), xs)
    starts = [s for s in range(0, t_local, stride) if s + window <= t_local]
    first = call(_map(lambda x: x[:, 0:window], xs_ext), 0)
    out, cover = buffers(first, t_local + overlap)
    _blend(out, cover, first, 0, window)
    for wi, s in enumerate(starts[1:], start=1):
        _blend(out, cover, call(_map(lambda x: x[:, s:s + window], xs_ext), wi), s, window)

    is_last = rank == n_chunks - 1
    spill_start = t_local - window if is_last else t_local - stride
    spill = call(_map(lambda x: x[:, spill_start:spill_start + window], xs_ext), len(starts))
    _blend(out, cover, spill, spill_start, window)

    # the spilled tail is the earlier contribution to the neighbour's first
    # `overlap` frames; the last rank sends zeros, marked as nothing
    right = [(i, (i + 1) % n_chunks) for i in range(n_chunks)]
    tail = out[:, t_local:] * (0.0 if is_last else 1.0)
    recv = ppermute(tail, right, group, rank)
    valid = ppermute(tail.new_full((1,), 0.0 if is_last else 1.0), right, group, rank)
    head = out[:, :overlap]
    head = torch.where(valid > 0, 0.5 * recv + 0.5 * head, head)
    return done(torch.cat([head, out[:, overlap:t_local]], dim=1))


def sharded_windowed_apply(fn: Callable, mesh=None, axis: str = "time", window: int = 8,
                           stride: int = 6):
    """``apply(x) -> out`` for a (B, T, ...) tensor that every rank of
    ``mesh``'s ``axis`` holds whole: each rank runs
    :func:`windowed_apply_local` on its chunk of T / n frames, and the
    chunks are gathered, so every rank returns the whole (B, T, ...)
    output."""
    group, n, rank = axis_group(mesh, axis)

    def apply(x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        if t % n:
            raise ValueError(f"{t} frames do not split over {n} ranks")
        t_local = t // n
        local = windowed_apply_local(fn, x[:, rank * t_local:(rank + 1) * t_local], n, window,
                                     stride, group=group, rank=rank)
        parts = all_gather(local, n, group)  # (n, B, T_local, ...)
        return parts.movedim(0, 1).reshape(x.shape[:1] + (t,) + tuple(local.shape[2:]))

    return apply


def reference_windowed_apply(fn, x: torch.Tensor, window: int = 8, stride: int = 6):
    """The serial plan on a whole clip (for equivalence tests): the loop of
    ref pipeline_upscale_a_video.py:619-635."""
    b, t = x.shape[:2]
    if t <= window:
        return fn(x)
    slots = [None] * t
    for start in range(0, t, stride):
        end = min(t, start + window)
        if end - start < window:
            start = end - window
        pred = fn(x[:, start:end])
        for k, idx in enumerate(range(start, end)):
            slots[idx] = pred[:, k] if slots[idx] is None else slots[idx] * 0.5 + pred[:, k] * 0.5
    return torch.stack(slots, dim=1)
