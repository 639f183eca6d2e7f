"""Attention modules: text cross / spatial self attention, temporal attention
with RoPE and the T5 bias, the per-block transformer, and the VAE's spatial
attention block. Mirror of ``upscale_a_video_tpu/nn/attention.py``.

``BasicTransformerBlock`` sends its text cross-attentions, its temporal
attention and its feed-forward to the fused kernels where their gates hold
(dispatch sites of the reference: ``:399-484``, ``:490-524``, ``:542-555``);
where the whole-block temporal kernel's gate fails, ``TemporalAttention``
sends its attention core to the fused temporal attention (``:132-147``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.attention import attention
from ..ops.cross_attention_block import cross_attention_block_fits, fused_cross_attention_block
from ..ops.fused_feedforward import feedforward_fits, fused_feedforward, gelu_tanh
from ..ops.fused_temporal_attention import (fused_temporal_attention,
                                            fused_temporal_attention_fits)
from ..ops.relpos import relative_position_buckets
from ..ops.rope import apply_rotary
from ..ops.temporal_attention_block import (fused_temporal_attention_block,
                                            temporal_attention_block_fits)
from .blocks import GroupNorm, LayerNorm, ResnetBlock3DCNN


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class CrossAttention(nn.Module):
    """Multi-head attention, q from the tokens, k/v from the context (or the
    tokens); no q/k/v bias (ref attention.py:44-289)."""

    def __init__(self, query_dim: int, cross_attention_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        kv_dim = cross_attention_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if context is None else context
        q = _split_heads(self.to_q(x), self.heads)
        k = _split_heads(self.to_k(kv), self.heads)
        v = _split_heads(self.to_v(kv), self.heads)
        out = attention(q, k, v, self.dim_head ** -0.5)
        return self.to_out[0](_merge_heads(out))


class RelativePositionBias(nn.Module):
    """The T5 bias: a (buckets, H) table looked up at the bucket of each
    (query, key) frame pair. The lookup's index depends only on T, so it is
    made once per (T, device) and kept outside the state dict; the table is
    read anew on every call, so the bias follows new weights."""

    def __init__(self, heads: int, num_buckets: int = 32, max_distance: int = 32):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)
        self._index = {}  # (T, device) -> (H, T, T) positions in the flattened table

    def forward(self, t: int) -> torch.Tensor:
        """(H, T, T) bias for T frames, contiguous, in the table's dtype."""
        table = self.relative_attention_bias.weight
        idx = self._index.get((t, table.device))
        if idx is None:
            buckets = relative_position_buckets(t, self.num_buckets, self.max_distance)
            heads = table.shape[1]
            flat = buckets[None].astype(np.int64) * heads + np.arange(heads)[:, None, None]
            idx = self._index[(t, table.device)] = torch.as_tensor(flat, device=table.device)
        return table.reshape(-1)[idx]


class TemporalAttention(nn.Module):
    """Attention across the frames of each pixel (ref attention.py:626-733):
    T5 bias, RoPE on the first 32 dims, q scaled before the rotation. q/k/v
    stay in the (B', T, H, D) layout, as in the JAX fused branch
    (``nn/attention.py:141-147``); the attention goes to the fused temporal
    attention where its gate holds, else to the plain attention."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64, rope_dim: int = 32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.rope_dim = heads, dim_head, rope_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.time_rel_pos_bias = RelativePositionBias(heads)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B', T, C) → (B', T, C)."""
        b, t, _ = x.shape
        h, d = self.heads, self.dim_head
        bias = self.time_rel_pos_bias(t)
        q = self.to_q(x).reshape(b, t, h, d) * (d ** -0.5)
        k = self.to_k(x).reshape(b, t, h, d)
        v = self.to_v(x).reshape(b, t, h, d)
        rot = min(self.rope_dim, d)
        q = apply_rotary(q, rot, seq_axis=-3)
        k = apply_rotary(k, rot, seq_axis=-3)
        if _cuda.route(x, fused_temporal_attention_fits(q)):
            out = fused_temporal_attention(q, k, v, bias)
        else:
            out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 1.0,
                            bias=bias[None]).transpose(1, 2)
        return self.to_out[0](out.reshape(b, t, h * d))


class SparseCausalAttention(nn.Module):
    """Self-attention whose keys and values are the tokens of frame 0 and of
    the previous frame (ref attention.py:567-623; JAX ``nn/attention.py:170``),
    off in the released config (``use_first_frame=false``). x: (B·F, S, C)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, video_length: int) -> torch.Tensor:
        bf, s, _ = x.shape
        b = bf // video_length
        former = torch.clamp(torch.arange(video_length, device=x.device) - 1, min=0)
        first = torch.zeros_like(former)

        def causal(t):
            t = t.reshape(b, video_length, s, -1)
            return torch.cat([t[:, first], t[:, former]], dim=2).reshape(bf, 2 * s, -1)

        q = _split_heads(self.to_q(x), self.heads)
        k = _split_heads(causal(self.to_k(x)), self.heads)
        v = _split_heads(causal(self.to_v(x)), self.heads)
        out = attention(q, k, v, self.dim_head ** -0.5)
        return self.to_out[0](_merge_heads(out))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * gelu_tanh(gate)


class FeedForward(nn.Module):
    """GEGLU MLP, mult 4; ``net.1`` is the reference's dropout."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """attn1 (self or text cross) → attn2 (text cross) → temporal attention
    → GEGLU FF, each with its residual (ref attention.py:414-564).

    Pyramid Attention Broadcast (JAX ``nn/attention.py:358-565``): given an
    ``attn_cache`` dict, the block returns ``(x, new_cache)`` whose entries
    (``attn1``, ``attn2``, ``attn_temporal``) are the attention deltas, the
    outputs after the projection and before the residual add; where
    ``use_flags`` sets the entry's kind and a delta is cached, that delta is
    reused and the attention is not computed. The fused kernels then return
    the delta (``add_residual=False``) and the add runs outside; the
    feed-forward keeps its fused residual. ``{}`` caches every entry; a
    marker dict caches only its keys."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, only_cross_attention: bool = False):
        super().__init__()
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.only_cross_attention = only_cross_attention
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, cross_attention_dim if only_cross_attention else None,
                                    heads, dim_head)
        if cross_attention_dim is not None:
            self.norm2 = LayerNorm(dim, eps=1e-5)
            self.attn2 = CrossAttention(dim, cross_attention_dim, heads, dim_head)
        else:
            self.norm2 = self.attn2 = None
        self.norm_temporal = LayerNorm(dim, eps=1e-5)
        self.attn_temporal = TemporalAttention(dim, heads, dim_head)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def _cross(self, norm, attn, x, context, video_length, add_residual=True):
        """attn(norm(x), context), plus x with ``add_residual``; ``context``
        is per clip (B, S, C)."""
        if _cuda.route(x, cross_attention_block_fits(x, context.shape[1], self.heads,
                                                     self.dim_head)):
            return fused_cross_attention_block(
                x, norm.weight, norm.bias, attn.to_q.weight, attn.to_k(context),
                attn.to_v(context), attn.to_out[0].weight, attn.to_out[0].bias,
                heads=self.heads, dim_head=self.dim_head, t_repeat=video_length,
                eps=norm.eps, add_residual=add_residual)
        delta = attn(norm(x), context.repeat_interleave(video_length, dim=0))
        return delta + x if add_residual else delta

    def _temporal(self, x, video_length, add_residual=True):
        """The temporal attention's delta in the (B·T, S, C) layout, plus x
        with ``add_residual``."""
        at, nt = self.attn_temporal, self.norm_temporal
        if _cuda.route(x, temporal_attention_block_fits(x, video_length, self.heads, at.rope_dim)):
            return fused_temporal_attention_block(
                x, nt.weight, nt.bias, at.to_q.weight, at.to_k.weight, at.to_v.weight,
                at.to_out[0].weight, at.to_out[0].bias, at.time_rel_pos_bias(video_length),
                video_length=video_length, rot_dim=at.rope_dim, eps=nt.eps,
                add_residual=add_residual)
        bt, s, c = x.shape
        b = bt // video_length
        xt = x.reshape(b, video_length, s, c).transpose(1, 2).reshape(b * s, video_length, c)
        out = at(nt(xt))
        if add_residual:
            out = out + xt
        return out.reshape(b, s, video_length, c).transpose(1, 2).reshape(bt, s, c)

    @staticmethod
    def _cached(compute, cache, flag: bool) -> torch.Tensor:
        """The cached delta when ``flag`` is set and a delta is cached (a
        marker, ``()``, or no entry means "compute"), else ``compute()``: a
        Python branch where JAX takes ``lax.cond``."""
        if flag and isinstance(cache, torch.Tensor):
            return cache
        return compute()

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor], video_length: int,
                attn_cache: Optional[dict] = None, use_flags: Optional[dict] = None):
        """x: (B·T, S, C) per-frame tokens; context: (B, S_txt, C_txt).
        Returns x, or (x, new_cache) when ``attn_cache`` is given."""
        if attn_cache is None:
            if self.only_cross_attention:
                x = self._cross(self.norm1, self.attn1, x, context, video_length)
            else:
                x = self.attn1(self.norm1(x)) + x
            if self.attn2 is not None:
                x = self._cross(self.norm2, self.attn2, x, context, video_length)
            x = self._temporal(x, video_length)
            return self._feedforward(x)

        flags = use_flags or {}
        new_cache = {}

        def attend(key, kind, compute):
            delta = self._cached(compute, attn_cache.get(key), flags.get(kind, False))
            if not attn_cache or key in attn_cache:  # {} keeps every entry
                new_cache[key] = delta
            return delta

        if self.only_cross_attention:
            x = attend("attn1", "cross", lambda: self._cross(
                self.norm1, self.attn1, x, context, video_length, add_residual=False)) + x
        else:
            x = attend("attn1", "spatial", lambda: self.attn1(self.norm1(x))) + x
        if self.attn2 is not None:
            x = attend("attn2", "cross", lambda: self._cross(
                self.norm2, self.attn2, x, context, video_length, add_residual=False)) + x
        x = attend("attn_temporal", "temporal",
                   lambda: self._temporal(x, video_length, add_residual=False)) + x
        return self._feedforward(x), new_cache

    def _feedforward(self, x):
        n3, ff = self.norm3, self.ff
        if _cuda.route(x, feedforward_fits(x)):
            return fused_feedforward(x, n3.weight, n3.bias, ff.net[0].proj.weight,
                                     ff.net[0].proj.bias, ff.net[2].weight, ff.net[2].bias,
                                     eps=n3.eps, add_residual=True)
        return ff(n3(x)) + x


class Transformer3DModel(nn.Module):
    """Per-level transformer with the leading (3,1,1) temporal resblock
    (ref attention.py:292-411). x: (B, T, H, W, C); context: (B, S, C_txt)."""

    def __init__(self, heads: int, dim_head: int, in_channels: int, num_layers: int = 1,
                 cross_attention_dim: Optional[int] = None, norm_num_groups: int = 32,
                 only_cross_attention: bool = False):
        super().__init__()
        inner = heads * dim_head
        g = min(32, norm_num_groups)
        self.resblock_temporal = ResnetBlock3DCNN(in_channels, temb_channels=None, groups=g,
                                                  groups_out=g, temporal_kernel=(3, 1, 1))
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim,
                                  only_cross_attention) for _ in range(num_layers)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor], attn_cache=None,
                use_flags=None):
        """Returns the output, or (output, caches) with ``attn_cache``, one
        entry per transformer block (:class:`BasicTransformerBlock`)."""
        x = self.resblock_temporal(x)
        b, t, hh, ww, c = x.shape
        residual = x.reshape(b * t, hh * ww, c)
        # per-frame GroupNorm: the statistics exclude T (ref attention.py:363,374)
        tokens = self.proj_in(self.norm(x.reshape(b * t, hh, ww, c)).reshape(b * t, hh * ww, c))
        caches = []
        for i, block in enumerate(self.transformer_blocks):
            if attn_cache is None:
                tokens = block(tokens, context, video_length=t)
            else:
                tokens, cache = block(tokens, context, t, attn_cache[i], use_flags)
                caches.append(cache)
        out = (self.proj_out(tokens) + residual).reshape(b, t, hh, ww, c)
        return out if attn_cache is None else (out, tuple(caches))


class SpatialAttentionBlock(nn.Module):
    """Per-frame single-head self-attention of the VAE mid block (vendored
    diffusers AttentionBlock). On an fp32 decode q/k/v go to the attention
    as bf16 with an fp32 softmax, as the reference does (``:699-703``);
    ``fp32_operands = True`` keeps them fp32 (the CLI's ``--decode_attn
    fp32``, JAX ``UAV_VAE_ATTN_F32``), which the card runs on the fp32
    flash kernel (``csrc/flash_attention_f32.cu``)."""

    def __init__(self, channels: int, num_head_channels: Optional[int] = None,
                 norm_num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.channels = channels
        self.heads = channels // num_head_channels if num_head_channels else 1
        self.group_norm = GroupNorm(norm_num_groups, channels, eps)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)
        self.fp32_operands = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, hh, ww, c = x.shape
        tokens = self.group_norm(x.reshape(b * t, hh, ww, c)).reshape(b * t, hh * ww, c)
        q, k, v = (_split_heads(f(tokens), self.heads) for f in (self.query, self.key, self.value))
        dt = q.dtype
        if dt == torch.float32 and not self.fp32_operands:
            q, k, v = q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
        out = attention(q, k, v, 1.0 / float(np.sqrt(c / self.heads)))
        out = self.proj_attn(_merge_heads(out).to(dt))
        return out.reshape(b, t, hh, ww, c) + x
