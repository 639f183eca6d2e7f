"""Temporal attention step of a transformer block: LN → q/k/v → RoPE (q
pre-scaled) → T-frame attention with the T5 bias → out-proj (+ residual), in
the native (B·T, S, C) token layout.

Replaces ``upscale_a_video_tpu/ops/temporal_attention_block.py::
fused_temporal_attention_block`` (Pallas ``_kernel``); the CUDA kernels are
``csrc/temporal_attention_block.cu``: a LayerNorm pass, the q/k/v product
of each head against the stacked (3C, C) weight on the GEMM core for tiles
of r pixels x all T frames, whose epilogue scales, rotates and runs the
T-frame attention in shared memory (q, k and v never reach device memory),
and the out-projection on the GEMM core with bias and residual.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _cuda
from .fused_feedforward import layer_norm
from .fused_temporal_attention import MAX_T, temporal_attention_plain
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


ROWS = 128  # the JAX kernel's row tile: it takes T that divide it, so does this gate
HEAD_WIDTHS = (64, 128)  # head widths the kernel is built for


def stacked_qkv(wq, wk, wv, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The q/k/v product's B operand: the torch Linear weights stacked,
    (3C, C) in ``dtype``, made once per version of the three weights (kept
    on ``wq``, :func:`_cuda.cached`): they are parameters."""
    return _cuda.cached(wq, f"qkv:{dtype}",
                        lambda w: torch.cat([w, wk, wv]).to(dtype).contiguous(), also=(wk, wv))


@functools.lru_cache(maxsize=8)
def rope_operands(t: int, rot: int, device: torch.device):
    """(T, rot/2) fp32 cos and sin on the card, made once per (T, rot, device)."""
    return tuple(_cuda.operand(a, torch.float32, "rope")
                 for a in rotary_tables(t, rot, device=device))


def temporal_attention_block_fits(x: torch.Tensor, video_length: int, heads: int,
                                  rot_dim: int = 32) -> bool:
    """bf16, C a multiple of 64, heads of 64 or 128 channels (the JAX gate's
    64-multiples that the kernel is built for), and T a divisor of 128 up to
    16 (the JAX gate's ``ROWS % t``: T = 5 goes to the module path and its
    fused temporal attention, as in the JAX package); any S."""
    bt, s, c = x.shape
    t = video_length
    if x.dtype != torch.bfloat16 or bt % t or c % heads or c % 64 or t > MAX_T or ROWS % t:
        return False
    return c // heads in HEAD_WIDTHS and min(rot_dim, c // heads) % 2 == 0


def fused_temporal_attention_block(x, ln_w, ln_b, wq, wk, wv, wo, bo, bias_htt, *,
                                   video_length: int, rot_dim: int = 32, eps: float = 1e-5,
                                   add_residual: bool = False):
    """x: (B·T, S, C) pre-norm tokens; wq/wk/wv/wo torch Linear weights
    (C, C), no q/k/v bias; bias_htt: (H, T, T). Returns the delta, or
    x + delta with ``add_residual``. Differentiable: the backward is the
    plain version's (``_cuda.differentiable``), the T5 bias included."""
    if not x.is_cuda:
        return temporal_attention_block_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, bias_htt,
                                              video_length, rot_dim, eps, add_residual)
    return _cuda.differentiable(_launch, temporal_attention_block_plain, x, ln_w, ln_b, wq, wk,
                                wv, wo, bo, bias_htt, video_length, rot_dim, eps, add_residual)


def _launch(x, ln_w, ln_b, wq, wk, wv, wo, bo, bias_htt, video_length, rot_dim, eps,
            add_residual):
    bt, s, c = x.shape
    t = video_length
    heads = bias_htt.shape[0]
    if not temporal_attention_block_fits(x, t, heads, rot_dim):
        raise ValueError(f"temporal_attention_block: unsupported x {tuple(x.shape)} {x.dtype} "
                         f"at T={t}, {heads} heads")
    rot = min(rot_dim, c // heads)
    bf = torch.bfloat16
    xf = _cuda.tma_operand(x, "x")
    lnw, lnb, wof, bof = (_cuda.weight(w, bf, n) for w, n in ((ln_w, "ln_w"), (ln_b, "ln_b"),
                                                               (wo, "wo"), (bo, "bo")))
    wqkv = _cuda.operand(stacked_qkv(wq, wk, wv), bf, "wqkv")
    bias = _cuda.operand(bias_htt.float(), torch.float32, "bias")
    cos, sin = rope_operands(t, rot, x.device)
    hn, o = (torch.empty(bt * s, c, device=x.device, dtype=bf) for _ in range(2))
    out = torch.empty_like(xf)
    rc = _cuda.lib().uav_temporal_attention_block(
        xf.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wqkv.data_ptr(), wof.data_ptr(),
        bof.data_ptr(), bias.data_ptr(), cos.data_ptr(), sin.data_ptr(), hn.data_ptr(),
        o.data_ptr(), out.data_ptr(), bt // t, t, s, c, heads, rot, float(eps),
        int(add_residual), _cuda.stream_ptr(x.device))
    _cuda.check(rc, "temporal_attention_block")
    _cuda.count("temporal_attention_block", (bt, s, c, t, int(add_residual)))
    return out
