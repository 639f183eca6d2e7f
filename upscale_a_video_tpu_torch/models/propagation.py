"""Flow-guided latent propagation, the training-free propagator of the
released path.

Mirror of ``upscale_a_video_tpu/models/propagation.py``: two sweeps over the
frames, backward (warping with the forward flow) then forward (warping with
the backward flow, chained on the backward sweep's output). Each step warps
the previously propagated frame, fuses it with the current one
(``fuse_scale``) and keeps the fusion where the forward-backward consistency
check passes. The sweeps are Python loops over the frames (the JAX package's
``lax.scan``); channels last: x (B, T, H, W, C), flows (B, T-1, Hf, Wf, 2).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.resize import resize_2d
from ..ops.warp import flow_warp


def _length_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1, keepdim=True)


def fb_consistency_check(flow_fw: torch.Tensor, flow_bw: torch.Tensor, alpha1: float = 0.01,
                         alpha2: float = 0.5) -> torch.Tensor:
    """1 where |wf + wb(wf(x))|² < α1·(|wf|² + |wb(wf(x))|²) + α2, else 0.
    flows: (B, H, W, 2) pixel offsets → (B, H, W, 1)."""
    flow_bw_warped = flow_warp(flow_bw, flow_fw, interpolation="bilinear")
    flow_diff = flow_fw + flow_bw_warped
    occ_thresh = alpha1 * (_length_sq(flow_fw) + _length_sq(flow_bw_warped)) + alpha2
    return (_length_sq(flow_diff) < occ_thresh).to(flow_fw.dtype)


def _resize_flows(flows: torch.Tensor, hw: Tuple[int, int], src_w: int) -> torch.Tensor:
    """Area-resize flows to the latent size, magnitudes scaled by w / src_w."""
    return resize_2d(flows, hw, method="area") * (1.0 * hw[1] / src_w)


def _prop_pass(feats: torch.Tensor, flows_prop: torch.Tensor, flows_check: torch.Tensor,
               reverse: bool, interpolation: str, fuse_scale: float, alpha1: float,
               alpha2: float) -> torch.Tensor:
    """One sweep. Backward (``reverse``): frame i = T-2 .. 0 takes frame i+1's
    result warped by flow i. Forward: frame i = 1 .. T-1 takes frame i-1's
    result warped by flow i-1."""
    t = feats.shape[1]
    if t == 1:
        return feats
    order = range(t - 2, -1, -1) if reverse else range(1, t)
    out = [None] * t
    prop = out[t - 1 if reverse else 0] = feats[:, t - 1 if reverse else 0]
    for i in order:
        f = i if reverse else i - 1
        mask = fb_consistency_check(flows_prop[:, f], flows_check[:, f], alpha1, alpha2)
        warped = flow_warp(prop, flows_prop[:, f], interpolation=interpolation)
        warped = warped * fuse_scale + feats[:, i] * (1.0 - fuse_scale)
        prop = out[i] = mask * warped + (1.0 - mask) * feats[:, i]
    return torch.stack(out, dim=1)


def propagate_latents(x: torch.Tensor, flows_forward: torch.Tensor,
                      flows_backward: torch.Tensor, interpolation: str = "nearest",
                      fuse_scale: float = 0.5, alpha1: float = 0.001,
                      alpha2: float = 0.05) -> torch.Tensor:
    """x̂0 latents (B, T, H, W, C) and pixel-resolution flows
    (B, T-1, Hf, Wf, 2) → the forward sweep's result, with the released
    hyperparameters as defaults."""
    h, w = x.shape[2:4]
    src_w = flows_forward.shape[3]
    ff = _resize_flows(flows_forward, (h, w), src_w)
    fb = _resize_flows(flows_backward, (h, w), src_w)
    kw = dict(interpolation=interpolation, fuse_scale=fuse_scale, alpha1=alpha1, alpha2=alpha2)
    feats_b = _prop_pass(x, ff, fb, reverse=True, **kw)
    return _prop_pass(feats_b, fb, ff, reverse=False, **kw)
