"""Temporal attention step of a transformer block in one kernel: LN → q/k/v
→ RoPE (q pre-scaled) → T-frame attention with the T5 bias → out-proj
(+ residual), in the native (B·T, S, C) token layout.

Replaces ``upscale_a_video_tpu/ops/temporal_attention_block.py::
fused_temporal_attention_block`` (Pallas ``_kernel``); the CUDA kernel is
``csrc/temporal_attention_block.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .fused_feedforward import layer_norm
from .fused_temporal_attention import temporal_attention_plain
from .rope import apply_rotary, rotary_tables


def temporal_attention_block_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, bias_htt,
                                   video_length: int, rot_dim: int = 32, eps: float = 1e-5,
                                   add_residual: bool = False):
    """The reference's ``_reference``: exactly the module chain
    norm_temporal → TemporalAttention, transposes included."""
    bt, s, c = x.shape
    t = video_length
    b = bt // t
    heads = bias_htt.shape[0]
    d = c // heads
    xt = x.reshape(b, t, s, c).transpose(1, 2).reshape(b * s, t, c)
    hn = layer_norm(xt, ln_w, ln_b, eps)
    q = F.linear(hn, wq.to(x.dtype)).reshape(b * s, t, heads, d)
    k = F.linear(hn, wk.to(x.dtype)).reshape(b * s, t, heads, d)
    v = F.linear(hn, wv.to(x.dtype)).reshape(b * s, t, heads, d)
    q = q * (d ** -0.5)
    rot = min(rot_dim, d)
    q = apply_rotary(q, rot, seq_axis=-3)
    k = apply_rotary(k, rot, seq_axis=-3)
    out = temporal_attention_plain(q, k, v, bias_htt).reshape(b * s, t, c)
    delta = F.linear(out, wo.to(x.dtype), bo.to(x.dtype))
    delta = delta.reshape(b, s, t, c).transpose(1, 2).reshape(bt, s, c)
    return delta + x if add_residual else delta


def _rows(c: int) -> int:
    return max(16, min(128, 32768 // c))


def _pixels_per_block(s: int, t: int, c: int) -> int:
    rows = _rows(c)
    r = rows // t if rows % t == 0 else 0
    return r if r and s % r == 0 and (r * t) in (16, 32, 64, 128) else 0


def temporal_attention_block_fits(x: torch.Tensor, video_length: int, heads: int,
                                  rot_dim: int = 32) -> bool:
    bt, s, c = x.shape
    t = video_length
    if x.dtype != torch.bfloat16 or bt % t or t > 16 or c % heads or c % 64:
        return False
    d = c // heads
    return d % 16 == 0 and min(rot_dim, d) % 2 == 0 and _pixels_per_block(s, t, c) > 0


def fused_temporal_attention_block(x, ln_w, ln_b, wq, wk, wv, wo, bo, bias_htt, *,
                                   video_length: int, rot_dim: int = 32, eps: float = 1e-5,
                                   add_residual: bool = False):
    """x: (B·T, S, C) pre-norm tokens; wq/wk/wv/wo torch Linear weights
    (C, C), no q/k/v bias; bias_htt: (H, T, T). Returns the delta, or
    x + delta with ``add_residual``."""
    if not x.is_cuda:
        return temporal_attention_block_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, bias_htt,
                                              video_length, rot_dim, eps, add_residual)
    bt, s, c = x.shape
    t = video_length
    heads = bias_htt.shape[0]
    d = c // heads
    rot = min(rot_dim, d)
    r = _pixels_per_block(s, t, c)
    if not r:
        raise ValueError(f"temporal_attention_block: no row tile for S={s}, T={t}, C={c}")
    bf = torch.bfloat16
    xf = _cuda.operand(x, bf, "x")
    ws = [_cuda.operand(w, bf, n) for w, n in ((ln_w, "ln_w"), (ln_b, "ln_b"), (wq, "wq"),
                                                (wk, "wk"), (wv, "wv"), (wo, "wo"), (bo, "bo"))]
    bias = _cuda.operand(bias_htt.float(), torch.float32, "bias")
    cos, sin = rotary_tables(t, rot, device=x.device)
    cos = _cuda.operand(cos, torch.float32, "cos")
    sin = _cuda.operand(sin, torch.float32, "sin")
    out = torch.empty_like(xf)
    rc = _cuda.lib().uav_temporal_attention_block(
        xf.data_ptr(), *[w.data_ptr() for w in ws], bias.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), out.data_ptr(), bt // t, t, s, c, heads, rot, r, float(eps),
        int(add_residual), _cuda.stream_ptr(x.device))
    _cuda.check(rc, "temporal_attention_block")
    _cuda.count("temporal_attention_block", (bt, s, c, t))
    return out
