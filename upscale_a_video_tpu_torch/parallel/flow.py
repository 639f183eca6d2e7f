"""Data-parallel optical flow over ranks (port of
``upscale_a_video_tpu/parallel/flow.py``).

The reference computes RAFT's flows in a serial clip loop
(ref RAFT/raft_bi.py:71-104) only to bound memory; the frame pairs are
independent. Here the 2·(T-1) directed pairs of a clip, forward pairs then
backward pairs, are one list of rows split over the ranks: each rank runs
RAFT on its block of rows (the last block padded to the same length with
rows of zeros, where JAX pads with black frames and drops their flows) and
one all-gather returns every flow to every rank. A rank's
block is run as at most two RAFT calls, its forward rows and its backward
rows, so one rank runs exactly the serial ``compute_flow_pair``'s two calls.
"""

from __future__ import annotations

from math import ceil
from typing import Tuple

import torch

from ..models.raft import RaftRunner, resize_flow
from ..ops.resize import resize_2d
from .mesh import all_gather, axis_group


def build_sharded_flows(runner: RaftRunner, mesh=None, axis: str = "win"):
    """``flows(frames) -> (fwd, bwd)`` with frames (B, T, H, W, 3) in [-1, 1]
    whole on every rank of ``mesh``'s ``axis`` and flows (B, T-1, H, W, 2)
    on every rank: ``compute_flow_pair``'s contract (ref raft_bi.py:47-104)."""
    group, n_dev, rank = axis_group(mesh, axis)

    @torch.no_grad()
    def flows(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, h, w, _ = frames.shape
        h8, w8 = int(ceil(h / 8) * 8), int(ceil(w / 8) * 8)
        f = resize_2d(frames, (h8, w8), "bilinear") if (h8, w8) != (h, w) else frames
        f1 = f[:, :-1].reshape(b * (t - 1), h8, w8, 3)
        f2 = f[:, 1:].reshape(b * (t - 1), h8, w8, 3)
        half = b * (t - 1)  # rows [0, half) forward pairs, [half, 2·half) backward
        rows = 2 * half
        per = -(-rows // n_dev)
        lo, hi = rank * per, (rank + 1) * per
        runs = []
        for first, second, base in ((f1, f2, 0), (f2, f1, half)):
            a, e = max(base, lo) - base, min(base + half, hi) - base  # rows of one direction
            if a < e:
                runs.append(runner(first[a:e], second[a:e]))
        out = torch.cat(runs) if runs else f1.new_zeros((0, h8, w8, 2))
        if out.shape[0] < per:  # rows past the last pair: zeros, dropped below
            out = torch.cat([out, out.new_zeros((per - out.shape[0], h8, w8, 2))])
        out = all_gather(out, n_dev, group).flatten(0, 1)[:rows]
        fwd, bwd = out[:half], out[half:]
        if (h8, w8) != (h, w):
            fwd, bwd = resize_flow(fwd, h, w), resize_flow(bwd, h, w)
        return fwd.reshape(b, t - 1, h, w, 2), bwd.reshape(b, t - 1, h, w, 2)

    return flows
