"""LayerNorm → short-KV text cross-attention → out-projection (+ residual).

Replaces ``upscale_a_video_tpu/ops/cross_attention_block.py::
fused_cross_attention_block`` (Pallas ``_kernel``); the CUDA kernel is
``csrc/cross_attention_block.cu``. As in the reference, the q-projection is
folded into the keys (``M = Wq·Kᵀ``) and the out-projection into the values
(``Vo = blockdiag(V)·Wo``) per clip, outside the kernel; the kernel runs
LN, the two products and the per-head softmax for every token.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fused_feedforward import layer_norm

SKV_PAD = 128


def fold(wq, k, v, wo, heads: int, dim_head: int):
    """torch Linear weights wq (H·D, C), wo (C, H·D) and projected k/v
    (B, Skv, H·D) → M (B, C, H·128) and Vo (B, H·128, C), keys zero-padded."""
    b, skv, _ = k.shape
    c = wq.shape[1]
    scale = dim_head ** -0.5
    wq_h = wq.float().t().reshape(c, heads, dim_head) * scale
    kh = k.float().reshape(b, skv, heads, dim_head)
    m = torch.einsum("chd,bkhd->bchk", wq_h, kh)
    m = torch.nn.functional.pad(m, (0, SKV_PAD - skv)).reshape(b, c, heads * SKV_PAD)
    vh = v.float().reshape(b, skv, heads, dim_head)
    wo_h = wo.float().t().reshape(heads, dim_head, c)
    vo = torch.einsum("bkhd,hdc->bhkc", vh, wo_h)
    vo = torch.nn.functional.pad(vo, (0, 0, 0, SKV_PAD - skv)).reshape(b, heads * SKV_PAD, c)
    return m, vo


def cross_attention_block_plain(x, ln_w, ln_b, m, vo, skv: int, bo, t_repeat: int,
                                eps: float = 1e-5, add_residual: bool = False):
    """The reference's ``_reference`` on the folded form."""
    bt, s, c = x.shape
    hk = m.shape[-1]
    heads = hk // SKV_PAD
    hn = layer_norm(x, ln_w, ln_b, eps)
    m_rep = m.repeat_interleave(t_repeat, dim=0).to(x.dtype)
    vo_rep = vo.repeat_interleave(t_repeat, dim=0).to(x.dtype)
    scores = torch.matmul(hn.float(), m_rep.float()).reshape(bt, s, heads, SKV_PAD)
    valid = torch.arange(SKV_PAD, device=x.device) < skv
    scores = scores.masked_fill(~valid, float("-inf"))
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.softmax(scores, dim=-1).reshape(bt, s, hk).to(x.dtype)
    out = torch.matmul(probs.float(), vo_rep.float()) + bo.float()
    if add_residual:
        out = out + x.float()
    return out.to(x.dtype)


def cross_attention_block_fits(x: torch.Tensor, skv: int, heads: int, dim_head: int) -> bool:
    bt, s, c = x.shape
    return (x.dtype == torch.bfloat16 and skv <= SKV_PAD and heads * dim_head == c
            and c % 16 == 0 and c <= 512 and s % 32 == 0)


def fused_cross_attention_block(x, ln_w, ln_b, wq, k, v, wo, bo, *, heads: int, dim_head: int,
                                t_repeat: int, eps: float = 1e-5, add_residual: bool = False):
    """x: (B·T, S, C) pre-norm tokens; k/v: (B, Skv, H·D) projected text keys
    and values (not repeated per frame). Returns the delta, or x + delta."""
    bt, s, c = x.shape
    b, skv, _ = k.shape
    if bt != b * t_repeat:
        raise ValueError(f"x batch {bt} is not the context batch {b} x t_repeat {t_repeat}")
    m, vo = fold(wq, k, v, wo, heads, dim_head)
    if not x.is_cuda:
        return cross_attention_block_plain(x, ln_w, ln_b, m, vo, skv, bo, t_repeat, eps,
                                           add_residual)
    bf = torch.bfloat16
    xf = _cuda.operand(x, bf, "x")
    m = _cuda.operand(m.to(bf), bf, "m")
    vo = _cuda.operand(vo.to(bf), bf, "vo")
    lnw, lnb, bof = (_cuda.operand(t, bf, n) for t, n in ((ln_w, "ln_w"), (ln_b, "ln_b"),
                                                           (bo, "bo")))
    out = torch.empty_like(xf)
    rc = _cuda.lib().uav_cross_attention_block(
        xf.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), m.data_ptr(), vo.data_ptr(),
        bof.data_ptr(), out.data_ptr(), bt, s, c, heads, skv, t_repeat, float(eps),
        int(add_residual), _cuda.stream_ptr(x.device))
    _cuda.check(rc, "cross_attention_block")
    _cuda.count("cross_attention_block", (bt, s, c, t_repeat))
    return out
