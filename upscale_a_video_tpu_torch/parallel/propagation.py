"""Distributed flow-guided latent propagation with one boundary frame per
hop (port of ``upscale_a_video_tpu/parallel/propagation.py``).

The training-free propagator (ref propagation_module.py:194-281) is a
frame-sequential recurrence, so a time-split pipeline cannot run it in
parallel without changing its result. This module keeps the result exactly
and exchanges only chunk-boundary frames: the recurrence is pipelined over
the ranks. In the backward sweep the last rank runs its chunk first and
sends its first frame's result (one frame) to the rank before, which then
runs its chunk, and so on; the forward sweep runs the other way. Each
propagation moves 2·(N-1) single frames between ranks instead of gathering
the clip. The sweep stays serial in depth, as it is by nature; where the
JAX program runs every chip through every hop and keeps the active one's
result, a rank here waits for its boundary, runs its chunk once and passes
the boundary on.

Used by the sharded denoise (``sharded_pipeline.py``) with the frame axis
split and the flows whole on every rank; it equals the serial
``models.propagation.propagate_latents`` bit for bit.
"""

from __future__ import annotations

import torch

from ..models.propagation import _resize_flows, fb_consistency_check
from ..ops.warp import flow_warp
from .mesh import recv_like, send


def comm_bytes_estimate(shape, n_chunks: int, dtype_bytes: int = 4) -> dict:
    """Bytes on the wire for one propagation: the old all-gather plan
    against this boundary-exchange plan. ``shape`` = (B, T, H, W, C), the
    whole clip."""
    b, t, h, w, c = shape
    frame = b * h * w * c * dtype_bytes
    return {
        "allgather_bytes": 2 * (n_chunks - 1) * t // n_chunks * frame * n_chunks,
        "boundary_bytes": 2 * (n_chunks - 1) * frame,
    }


def _local_pass(feats, flows_prop, flows_check, start: int, t: int, boundary, reverse: bool,
                interpolation: str, fuse_scale: float, alpha1: float, alpha2: float):
    """One sweep over this rank's chunk (global frames ``start`` ..) seeded
    by ``boundary``, the neighbouring chunk's edge result. The per-frame
    arithmetic is ``models.propagation._prop_pass``'s: backward, frame i
    takes frame i+1's result warped by flow i; forward, frame i takes frame
    i-1's warped by flow i-1; the sweep's first frame of the clip passes
    through."""
    n = feats.shape[1]
    out = [None] * n
    prop = boundary
    for j in (range(n - 1, -1, -1) if reverse else range(n)):
        i = start + j
        if i == (t - 1 if reverse else 0):
            prop = out[j] = feats[:, j]
            continue
        f = i if reverse else i - 1
        mask = fb_consistency_check(flows_prop[:, f], flows_check[:, f], alpha1, alpha2)
        warped = flow_warp(prop, flows_prop[:, f], interpolation=interpolation)
        warped = warped * fuse_scale + feats[:, j] * (1.0 - fuse_scale)
        prop = out[j] = mask * warped + (1.0 - mask) * feats[:, j]
    return torch.stack(out, dim=1)


def _pipelined_pass(feats, flows_prop, flows_check, start: int, t: int, group, rank: int,
                    n_chunks: int, reverse: bool, **kw):
    """The sweep chained over the ranks: backward from the last rank toward
    rank 0, forward from rank 0 on, one boundary frame per hop."""
    prev, nxt = (rank + 1, rank - 1) if reverse else (rank - 1, rank + 1)
    edge = 0 if reverse else -1
    boundary = feats[:, edge]  # read only where the chain starts, at the clip's end frame
    if 0 <= prev < n_chunks:
        boundary = recv_like(boundary, prev, group)
    out = _local_pass(feats, flows_prop, flows_check, start, t, boundary, reverse, **kw)
    if 0 <= nxt < n_chunks:
        send(out[:, edge], nxt, group)
    return out


def distributed_propagate_latents(x_local: torch.Tensor, flows_forward: torch.Tensor,
                                  flows_backward: torch.Tensor, n_chunks: int, group=None,
                                  rank: int = 0, interpolation: str = "nearest",
                                  fuse_scale: float = 0.5, alpha1: float = 0.001,
                                  alpha2: float = 0.05) -> torch.Tensor:
    """``propagate_latents`` on a frame-split clip: ``x_local`` (B, L, H, W,
    C) is chunk ``rank`` of ``n_chunks`` over ``group`` (``mesh.axis_group``),
    the pixel-resolution flows (B, T-1, Hf, Wf, 2) whole on every rank.
    Returns this rank's chunk of the result, equal to the serial one."""
    l = x_local.shape[1]
    t, start = l * n_chunks, rank * l
    h, w = x_local.shape[2:4]
    src_w = flows_forward.shape[3]
    ff = _resize_flows(flows_forward, (h, w), src_w)
    fb = _resize_flows(flows_backward, (h, w), src_w)
    kw = dict(interpolation=interpolation, fuse_scale=fuse_scale, alpha1=alpha1, alpha2=alpha2)
    feats_b = _pipelined_pass(x_local, ff, fb, start, t, group, rank, n_chunks, True, **kw)
    return _pipelined_pass(feats_b, fb, ff, start, t, group, rank, n_chunks, False, **kw)
