"""Attention over the T frames of each (row, head) on already projected,
scaled and rotated q/k/v in the (B', T, H, D) layout, with the (H, T, T)
relative-position bias: the temporal attention of ``TemporalAttention`` when
the whole-block kernel's gate fails (T that no row tile divides).

Replaces ``upscale_a_video_tpu/ops/fused_temporal_attention.py::
fused_temporal_attention`` (Pallas ``_kernel``; oracle ``_reference``); the
CUDA kernel is ``csrc/fused_temporal_attention.cu``. The JAX gate's S | 128
and B'·S >= 2048 are limits of the TPU's tiles; the Hopper gate is bf16,
T <= 16, D % 16 == 0 and q/k/v of one row fitting in shared memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

MAX_T = 16
SMEM_BYTES = 227 * 1024


def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias_htt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q/k/v: (B', T, H, D) with RoPE applied → (B', T, H, D); softmax over
    the T keys of each (row, head, query) with the (H, T, T) bias."""
    scores = torch.einsum("bihd,bjhd->bhij", q.float(), k.float())
    if bias_htt is not None:
        scores = scores + bias_htt[None].float()
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhij,bjhd->bihd", probs.float(), v.float()).to(q.dtype)


def fused_temporal_attention_fits(q: torch.Tensor) -> bool:
    _, t, h, d = q.shape
    return (q.dtype == torch.bfloat16 and 1 <= t <= MAX_T and d % 16 == 0
            and 3 * t * h * d * 2 <= SMEM_BYTES)


def fused_temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q/k/v: (B', T, H, D), scale pre-applied to q; bias: (H, T, T) or None.
    Returns (B', T, H, D)."""
    if not q.is_cuda:
        return temporal_attention_plain(q, k, v, bias)
    bp, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or not fused_temporal_attention_fits(q):
        raise ValueError(f"fused_temporal_attention: unsupported q/k/v {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} ({q.dtype})")
    bf = torch.bfloat16
    qf, kf, vf = (_cuda.operand(a, bf, n) for a, n in ((q, "q"), (k, "k"), (v, "v")))
    bias_f = None
    if bias is not None:
        if tuple(bias.shape) != (h, t, t):
            raise ValueError(f"fused_temporal_attention: bias {tuple(bias.shape)} is not "
                             f"{(h, t, t)}")
        bias_f = _cuda.operand(bias.float(), torch.float32, "bias")
    out = torch.empty_like(qf)
    rc = _cuda.lib().uav_fused_temporal_attention(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), _cuda.ptr(bias_f), out.data_ptr(), bp, t,
        h, d, _cuda.stream_ptr(q.device))
    _cuda.check(rc, "fused_temporal_attention")
    _cuda.count("fused_temporal_attention", tuple(q.shape))
    return out
