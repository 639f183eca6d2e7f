"""The temporal-transformer stack of TemporalModule3D's attention branch
(mirror of ``upscale_a_video_tpu/nn/temporal_transformer.py``; ref
temporal_module.py:197-693), off in the released config: per-block spatial
and temporal self-attention in the modes ``Temporal``, ``Spatial``,
``CrossFrame`` (keys and values concatenated across frames) and
``SpatialTemporalShift`` (a TSM channel shift of keys and values),
AdaLayerNorm timestep conditioning, and the DCN or flow ``WarpModule``.

Parameter names are what ``weights.to_state_dict`` gives the JAX tree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.deform_conv import deform_conv2d
from ..ops.fused_feedforward import layer_norm
from ..ops.warp import grid_sample
from .attention import FeedForward, _merge_heads, _split_heads
from .blocks import GroupNorm, LayerNorm


class AdaLayerNorm(nn.Module):
    """LayerNorm without affine, scaled and shifted by the embedded timestep
    (ref :674-693); the (B,) timesteps are repeated over the B'/B rows."""

    def __init__(self, dim: int, num_embeddings: int = 1000):
        super().__init__()
        self.emb = nn.Embedding(num_embeddings, dim)
        self.linear = nn.Linear(dim, dim * 2)

    def forward(self, x: torch.Tensor, timestep) -> torch.Tensor:
        ts = torch.as_tensor(timestep, device=x.device).reshape(-1).long()
        t = ts.repeat_interleave(x.shape[0] // max(ts.shape[0], 1)).expand(x.shape[0])
        scale, shift = self.linear(F.silu(self.emb(t)))[:, None].chunk(2, dim=-1)
        ones = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
        return layer_norm(x, ones, torch.zeros_like(ones), 1e-5) * (1 + scale) + shift


def _frame_index(video_length: int, mode: str):
    cur = np.arange(video_length)
    former = np.maximum(cur - 1, 0)
    later = np.concatenate([cur[1:], [video_length - 1]])
    first = np.zeros_like(cur)
    table = {"0_i-1": (first, former), "i-1_i": (former, cur), "0_i-1_i": (first, former, cur),
             "i-1_i_i+1": (former, cur, later)}
    if mode not in table:
        raise NotImplementedError(mode)
    return table[mode]


def temporal_token_concat(x: torch.Tensor, video_length: int, mode: Optional[str]) -> torch.Tensor:
    """Keys or values of the frames that ``mode`` names, concatenated along
    the tokens (ref :471-496). x: (B·F, S, C) → (B·F, n·S, C)."""
    if mode is None:
        return x
    bf, s, c = x.shape
    t = x.reshape(bf // video_length, video_length, s, c)
    parts = [t[:, torch.as_tensor(i, device=x.device)] for i in _frame_index(video_length, mode)]
    return torch.cat(parts, dim=2).reshape(bf, -1, c)


def temporal_shift(x: torch.Tensor, video_length: int, fold_div: int = 2,
                   direction: str = "right") -> torch.Tensor:
    """TSM channel shift (ref :498-512): the first C / fold_div channels of
    each frame come from the frame before (zeros for frame 0)."""
    if direction != "right":
        raise NotImplementedError(direction)
    bf, s, c = x.shape
    t = x.reshape(bf // video_length, video_length, s, c)
    fold = c // fold_div
    shifted = torch.cat([torch.zeros_like(t[:, :1, :, :fold]), t[:, :-1, :, :fold]], dim=1)
    return torch.cat([shifted, t[..., fold:]], dim=-1).reshape(bf, s, c)


class VersatileSelfAttention(nn.Module):
    """Self-attention with the mode's keys and values (ref :443-579) on
    (B·F, S, C) per-frame tokens; ``Temporal`` attends across the frames of
    each token. ``to_out.0`` is zero-initialised (``zero_init_out``)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 attention_mode: Optional[str] = None,
                 cross_frame_attention_mode: Optional[str] = None,
                 temporal_shift_fold_div: int = 2, temporal_shift_direction: str = "right",
                 zero_init_out: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.mode = heads, dim_head, attention_mode
        self.cross_frame_attention_mode = cross_frame_attention_mode
        self.fold_div, self.direction = temporal_shift_fold_div, temporal_shift_direction
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        if zero_init_out:
            nn.init.zeros_(self.to_out[0].weight)

    def forward(self, x: torch.Tensor, video_length: int) -> torch.Tensor:
        if self.mode == "Temporal":
            bf, d, c = x.shape
            x = x.reshape(bf // video_length, video_length, d, c).transpose(1, 2).reshape(
                -1, video_length, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if self.mode == "SpatialTemporalShift":
            k = temporal_shift(k, video_length, self.fold_div, self.direction)
            v = temporal_shift(v, video_length, self.fold_div, self.direction)
        elif self.mode == "CrossFrame":
            k = temporal_token_concat(k, video_length, self.cross_frame_attention_mode)
            v = temporal_token_concat(v, video_length, self.cross_frame_attention_mode)
        out = attention(_split_heads(q, self.heads), _split_heads(k, self.heads),
                        _split_heads(v, self.heads), self.dim_head ** -0.5)
        out = self.to_out[0](_merge_heads(out))
        if self.mode == "Temporal":
            c = out.shape[-1]
            out = out.reshape(-1, d, video_length, c).transpose(1, 2).reshape(-1, d, c)
        return out


class WarpModule(nn.Module):
    """Warp of the hidden states driven by the attention's output (ref
    :582-671): a 3×3 conv of [x, attention output] gives DCN offsets and a mask
    (``use_deformable_conv``, then ``alpha · dcn(x) + x``) or a flow (the
    reference's masked bilinear warp). ``weight``/``bias`` are that conv's;
    the DCN's are ``dcn_weight`` (torch layout) and the gate ``alpha``."""

    def __init__(self, in_channels: int, use_deformable_conv: bool = True):
        super().__init__()
        self.use_deformable_conv = use_deformable_conv
        out = 27 if use_deformable_conv else 2
        conv = nn.Conv2d(2 * in_channels, out, 3, padding=1)
        self.weight, self.bias = conv.weight, conv.bias
        if use_deformable_conv:
            self.dcn_weight = nn.Parameter(
                torch.randn(in_channels, in_channels, 3, 3) / np.sqrt(in_channels * 9))
            self.alpha = nn.Parameter(torch.zeros(1, 1, 1, in_channels))
        else:
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, hidden_states: torch.Tensor, offset_hidden_states: torch.Tensor):
        b, s, c = hidden_states.shape
        size = int(round(s ** 0.5))
        if size * size != s:
            raise ValueError(f"WarpModule expects a square token grid, got {s} tokens")
        x = hidden_states.reshape(b, size, size, c)
        cat = torch.cat([x, offset_hidden_states.reshape(b, size, size, c)], dim=-1)
        conv = F.conv2d(cat.permute(0, 3, 1, 2), self.weight, self.bias, padding=1)
        conv = conv.permute(0, 2, 3, 1)
        if self.use_deformable_conv:
            ox, oy, mask = conv.chunk(3, dim=-1)
            warped = deform_conv2d(x, torch.cat([ox, oy], dim=-1), self.dcn_weight,
                                   mask=torch.sigmoid(mask) * 2, padding=1)
            out = self.alpha * warped + x
        else:
            out = self.flow_warp_masked(x, conv)
        return out.reshape(b, s, c)

    @staticmethod
    def flow_warp_masked(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """ref optical_flow_warping (:632-671): an align_corners bilinear
        warp times the reference's mask, which is a second warp of x
        thresholded at 0.9999 (it overwrites its ones-mask; kept as is)."""
        b, h, w, c = x.shape
        yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
        xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
        gx = 2.0 * (xx + flow[..., 0].float()) / max(w - 1, 1) - 1.0
        gy = 2.0 * (yy + flow[..., 1].float()) / max(h - 1, 1) - 1.0
        grid = torch.stack([gx, gy], dim=-1)
        out = grid_sample(x.float(), grid, "bilinear", "zeros", True)
        mask = torch.where(out < 0.9999, 0.0, 1.0)
        return (out * mask).to(x.dtype)


class TemporalTransformerBlock(nn.Module):
    """ref :322-440: the optional first attention, the second attention (or
    the WarpModule it drives), the feed-forward; AdaLayerNorm where
    ``num_embeds_ada_norm`` is set."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 attention_block_types: Tuple[str, str] = ("Temporal", "Temporal"),
                 cross_frame_attention_mode: Optional[str] = None,
                 temporal_shift_fold_div: int = 2, temporal_shift_direction: str = "right",
                 num_embeds_ada_norm: Optional[int] = 1000, use_dcn_warpping: bool = False,
                 use_deformable_conv: bool = True):
        super().__init__()
        self.ada = num_embeds_ada_norm is not None
        self.use_dcn_warpping = use_dcn_warpping
        norm = (lambda: AdaLayerNorm(dim, num_embeds_ada_norm)) if self.ada else (
            lambda: LayerNorm(dim, eps=1e-5))
        attn = lambda mode: VersatileSelfAttention(
            dim, heads, dim_head, mode or None, cross_frame_attention_mode,
            temporal_shift_fold_div, temporal_shift_direction)
        if attention_block_types[0] != "":
            self.norm1, self.attn_spatial = norm(), attn(attention_block_types[0])
        else:
            self.norm1 = self.attn_spatial = None
        self.norm2, self.attn_temporal = norm(), attn(attention_block_types[1])
        self.dcn_module = WarpModule(dim, use_deformable_conv) if use_dcn_warpping else None
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def _norm(self, norm, x, timestep):
        return norm(x, timestep) if self.ada else norm(x)

    def forward(self, x: torch.Tensor, timestep, video_length: int) -> torch.Tensor:
        if self.attn_spatial is not None:
            x = self.attn_spatial(self._norm(self.norm1, x, timestep), video_length) + x
        attn_out = self.attn_temporal(self._norm(self.norm2, x, timestep), video_length)
        x = self.dcn_module(x, attn_out) if self.dcn_module is not None else attn_out + x
        return self.ff(self.norm3(x)) + x


class TemporalTransformer3DModel(nn.Module):
    """ref :197-319: per-frame GroupNorm → proj_in → blocks → proj_out, plus
    the input. x: (B, T, H, W, C)."""

    def __init__(self, heads: int, dim_head: int, in_channels: int, num_layers: int = 1,
                 norm_num_groups: int = 8,
                 attention_block_types: Tuple[str, str] = ("Temporal", "Temporal"),
                 cross_frame_attention_mode: Optional[str] = None,
                 num_embeds_ada_norm: Optional[int] = 1000, use_dcn_warpping: bool = False,
                 use_deformable_conv: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(inner, heads, dim_head, attention_block_types,
                                     cross_frame_attention_mode,
                                     num_embeds_ada_norm=num_embeds_ada_norm,
                                     use_dcn_warpping=use_dcn_warpping,
                                     use_deformable_conv=use_deformable_conv)
            for _ in range(num_layers)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor, timestep) -> torch.Tensor:
        b, t, hh, ww, c = x.shape
        tokens = self.proj_in(self.norm(x.reshape(b * t, hh, ww, c)).reshape(b * t, hh * ww, c))
        for block in self.transformer_blocks:
            tokens = block(tokens, timestep, t)
        return self.proj_out(tokens).reshape(b, t, hh, ww, c) + x
