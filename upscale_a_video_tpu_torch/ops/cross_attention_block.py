"""LayerNorm → short-KV text cross-attention → out-projection (+ residual).

Replaces ``upscale_a_video_tpu/ops/cross_attention_block.py::
fused_cross_attention_block`` (Pallas ``_kernel``); the CUDA kernel is
``csrc/cross_attention_block.cu``. As in the reference, the q-projection is
folded into the keys (``M = Wq·Kᵀ``) and the out-projection into the values
(``Vo = blockdiag(V)·Wo``) per clip and per call, outside the kernel
(:func:`fold_keys`, two batched products; the text context is step- and
frame-invariant and the fold is small). The kernel runs LN, the two products
and the per-head softmax for every token, flash-attention style on TMA +
``wgmma``, reading each head's keys as a tile of 80 (at most 80 keys, as
CLIP's 77) or 128, the padding zero-filled and masked. The plain version
keeps the reference's 128-key layout (:func:`fold`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .fused_feedforward import layer_norm

SKV_PAD = 128
KERNEL_WIDTHS = (128, 256, 384, 512)  # C the kernel is built for


def fold_keys(wq, k, v, wo, heads: int, dim_head: int):
    """torch Linear weights wq (H·D, C), wo (C, H·D) and projected k/v
    (B, Skv, H·D) → Mt and Vo, both (H, B, Skv, C) in k's dtype: Mt[h, b, j]
    is key j of head h through the scaled q-projection, Vo[h, b, j] value j
    through the out-projection. Two batched products over the heads, on
    strided views of k, v and the weights, each rounded once (the scale is
    applied to the fp32 sum). The kernel reads each (h, b) as one box of 80
    rows (Skv <= 80) or 128, TMA zero-filling the rows past Skv."""
    b, skv, _ = k.shape
    c = wq.shape[1]
    kh = k.reshape(b * skv, heads, dim_head).transpose(0, 1)  # (H, B·Skv, D)
    vh = v.reshape(b * skv, heads, dim_head).transpose(0, 1)
    wq_h = wq.to(k.dtype).reshape(heads, dim_head, c)          # [h, d, c] = wq[h·D + d, c]
    wo_h = wo.to(v.dtype).t().reshape(heads, dim_head, c)      # [h, d, c] = wo[c, h·D + d]
    mt = torch.baddbmm(kh.new_empty(()), kh, wq_h, beta=0, alpha=dim_head ** -0.5)
    vo = torch.bmm(vh, wo_h)
    return mt.reshape(heads, b, skv, c), vo.reshape(heads, b, skv, c)


def key_tiles(mt, vo, kp: int):
    """Mt and Vo of :func:`fold_keys` with each head's keys zero-padded to
    kp, in the plain version's layout: M (B, C, H·kp), Vo (B, H·kp, C)."""
    heads, b, skv, c = mt.shape
    pad = lambda a: F.pad(a, (0, 0, 0, kp - skv)).permute(1, 0, 2, 3)  # (B, H, kp, C)
    return pad(mt).reshape(b, heads * kp, c).transpose(1, 2), pad(vo).reshape(b, heads * kp, c)


def fold(wq, k, v, wo, heads: int, dim_head: int):
    """The reference's layout, 128 keys a head: M (B, C, H·128), Vo (B, H·128, C)."""
    return key_tiles(*fold_keys(wq, k, v, wo, heads, dim_head), SKV_PAD)


def cross_attention_block_plain(x, ln_w, ln_b, m, vo, skv: int, bo, t_repeat: int,
                                eps: float = 1e-5, add_residual: bool = False,
                                kp: int = SKV_PAD):
    """The reference's ``_reference`` on the folded form, m (B, C, H·kp),
    vo (B, H·kp, C); keys ≥ skv of each head masked."""
    bt, s, c = x.shape
    hk = m.shape[-1]
    heads = hk // kp
    hn = layer_norm(x, ln_w, ln_b, eps)
    # each clip's keys for its T frames: a broadcast, whose backward is a sum
    # in a fixed order (repeat_interleave's adds atomically on the card)
    rep = lambda a: a[:, None].expand(a.shape[0], t_repeat, *a.shape[1:]).reshape(
        -1, *a.shape[1:]).to(x.dtype)
    m_rep, vo_rep = rep(m), rep(vo)
    scores = torch.matmul(hn.float(), m_rep.float()).reshape(bt, s, heads, kp)
    valid = torch.arange(kp, device=x.device) < skv
    scores = scores.masked_fill(~valid, float("-inf"))
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.softmax(scores, dim=-1).reshape(bt, s, hk).to(x.dtype)
    out = torch.matmul(probs.float(), vo_rep.float()) + bo.float()
    if add_residual:
        out = out + x.float()
    return out.to(x.dtype)


def cross_attention_block_fits(x: torch.Tensor, skv: int, heads: int, dim_head: int) -> bool:
    """bf16, at most 128 keys, C in KERNEL_WIDTHS (the JAX gate's c % 128 and
    c <= 512) and ``heads·dim_head == C``; any number of tokens (TMA
    zero-fills the last row tile, whose stores are masked)."""
    bt, s, c = x.shape
    return (x.dtype == torch.bfloat16 and 1 <= skv <= SKV_PAD and heads * dim_head == c
            and c in KERNEL_WIDTHS and s >= 1)


def fused_cross_attention_block(x, ln_w, ln_b, wq, k, v, wo, bo, *, heads: int, dim_head: int,
                                t_repeat: int, eps: float = 1e-5, add_residual: bool = False):
    """x: (B·T, S, C) pre-norm tokens; k/v: (B, Skv, H·D) projected text keys
    and values (not repeated per frame). Returns the delta, or x + delta.
    Differentiable: the fold runs under autograd outside the kernel's call,
    whose backward is the plain version's on the folded M and Vo
    (``_cuda.differentiable``), as JAX's VJP differentiates with respect to
    M and Vo (``cross_attention_block.py:155``)."""
    bt, s, c = x.shape
    b, skv, _ = k.shape
    if bt != b * t_repeat:
        raise ValueError(f"x batch {bt} is not the context batch {b} x t_repeat {t_repeat}")
    if not x.is_cuda:
        m, vo = fold(wq, k, v, wo, heads, dim_head)
        return cross_attention_block_plain(x, ln_w, ln_b, m, vo, skv, bo, t_repeat, eps,
                                           add_residual)
    if not cross_attention_block_fits(x, skv, heads, dim_head):
        raise ValueError(f"cross_attention_block: unsupported x {tuple(x.shape)} {x.dtype}, "
                         f"{skv} keys, {heads} x {dim_head} heads")
    mt, vo = fold_keys(wq, k, v, wo, heads, dim_head)
    return _cuda.differentiable(_launch, folded_plain, x, ln_w, ln_b, mt, vo, bo, t_repeat, eps,
                                add_residual)


def folded_plain(x, ln_w, ln_b, mt, vo, bo, t_repeat, eps, add_residual):
    """The plain version on :func:`fold_keys`' Mt and Vo (H, B, Skv, C)."""
    m, vo_tiles = key_tiles(mt, vo, SKV_PAD)
    return cross_attention_block_plain(x, ln_w, ln_b, m, vo_tiles, mt.shape[2], bo, t_repeat,
                                       eps, add_residual)


def _launch(x, ln_w, ln_b, mt, vo, bo, t_repeat, eps, add_residual):
    bt, s, c = x.shape
    heads, _, skv, _ = mt.shape
    bf = torch.bfloat16
    mt, vo = _cuda.tma_operand(mt, "mt"), _cuda.tma_operand(vo, "vo")
    xf = _cuda.tma_operand(x, "x")
    lnw, lnb, bof = (_cuda.weight(t, bf, n) for t, n in ((ln_w, "ln_w"), (ln_b, "ln_b"),
                                                          (bo, "bo")))
    out = torch.empty_like(xf)
    rc = _cuda.lib().uav_cross_attention_block(
        xf.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), mt.data_ptr(), vo.data_ptr(),
        bof.data_ptr(), out.data_ptr(), bt, s, c, heads, skv, t_repeat, float(eps),
        int(add_residual), _cuda.stream_ptr(x.device))
    _cuda.check(rc, "cross_attention_block")
    _cuda.count("cross_attention_block", (bt, s, c, t_repeat, int(add_residual)))
    return out
