"""The temporal video UNet (mirror of ``upscale_a_video_tpu/models/unet_video.py``).

Input = concat(noisy latents 4ch, noised LR frames 3ch); the noise-level class
embedding is added to the timestep embedding; a TemporalModule3D follows
every down/mid/up block; upsample sizes are forced to the next skip's size.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import UNetVideoConfig
from ..nn.blocks import GroupNorm, InflatedConv, TimestepEmbedding
from ..nn.temporal import TemporalModule3D
from ..nn.unet_blocks import (CrossAttnDownBlock3D, CrossAttnUpBlock3D, DownBlock3D,
                              UNetMidBlock3DCrossAttn, UpBlock3D)
from ..ops.embeddings import get_timestep_embedding


def _per_row(v, b: int, device) -> torch.Tensor:
    """A scalar or (B,) timestep or label as a (B,) tensor on ``device``; a
    Python number by a fill, not a host-to-device copy, which a CUDA graph
    capture of the denoise loop would refuse."""
    if torch.is_tensor(v):
        return v.to(device).reshape(-1).expand(b)
    return torch.full((b,), v, device=device)


class UNetVideoModel(nn.Module):
    """``use_remat`` (JAX ``use_remat``, ``_maybe_remat``): under autograd
    each down, mid and up block and each TemporalModule3D is recomputed on
    the backward pass (``torch.utils.checkpoint``, non-reentrant) instead of
    keeping its activations; its kernels then launch twice a step."""

    def __init__(self, config: UNetVideoConfig = UNetVideoConfig(), use_remat: bool = False):
        super().__init__()
        cfg = self.config = config
        self.use_remat = use_remat
        boc = cfg.block_out_channels
        temb = boc[0] * 4
        groups = min(32, cfg.norm_num_groups)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        self.class_embedding = (nn.Embedding(cfg.num_class_embeds, temb)
                                if cfg.num_class_embeds is not None else None)
        self.conv_in = InflatedConv(cfg.in_channels, boc[0], 3, padding=1)

        n = len(cfg.down_block_types)
        self.down_blocks = nn.ModuleList()
        self.down_temp_blocks = nn.ModuleDict()
        out_ch = boc[0]
        for i, kind in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, boc[i]
            common = dict(in_channels=in_ch, out_channels=out_ch, temb_channels=temb,
                          num_layers=cfg.layers_per_block, resnet_eps=cfg.norm_eps,
                          resnet_groups=cfg.norm_num_groups, add_downsample=i != n - 1)
            if kind == "CrossAttnDownBlock3D":
                block = CrossAttnDownBlock3D(**common,
                                             attn_num_head_channels=cfg.attention_head_dim,
                                             cross_attention_dim=cfg.cross_attention_dim,
                                             only_cross_attention=cfg.only_cross_attention[i])
            elif kind == "DownBlock3D":
                block = DownBlock3D(**common)
            else:
                raise ValueError(f"unknown down block {kind}")
            self.down_blocks.append(block)
            if i in cfg.down_temporal_idx:
                self.down_temp_blocks[str(i)] = TemporalModule3D(out_ch, temb, groups)

        self.mid_block = UNetMidBlock3DCrossAttn(
            boc[-1], temb, resnet_eps=cfg.norm_eps, resnet_groups=cfg.norm_num_groups,
            attn_num_head_channels=cfg.attention_head_dim,
            cross_attention_dim=cfg.cross_attention_dim)
        self.mid_temp_block = TemporalModule3D(boc[-1], temb, groups) if cfg.mid_temporal else None

        rev = list(reversed(boc))
        only_cross = list(reversed(cfg.only_cross_attention))
        self.up_blocks = nn.ModuleList()
        self.up_temp_blocks = nn.ModuleDict()
        out_ch = rev[0]
        for i, kind in enumerate(cfg.up_block_types):
            prev, out_ch = out_ch, rev[i]
            common = dict(in_channels=rev[min(i + 1, n - 1)], out_channels=out_ch,
                          prev_output_channel=prev, temb_channels=temb,
                          num_layers=cfg.layers_per_block + 1, resnet_eps=cfg.norm_eps,
                          resnet_groups=cfg.norm_num_groups, add_upsample=i != n - 1)
            if kind == "CrossAttnUpBlock3D":
                block = CrossAttnUpBlock3D(**common, attn_num_head_channels=cfg.attention_head_dim,
                                           cross_attention_dim=cfg.cross_attention_dim,
                                           only_cross_attention=only_cross[i])
            elif kind == "UpBlock3D":
                block = UpBlock3D(**common)
            else:
                raise ValueError(f"unknown up block {kind}")
            self.up_blocks.append(block)
            if i in cfg.up_temporal_idx:
                self.up_temp_blocks[str(i)] = TemporalModule3D(out_ch, temb, groups)

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0], cfg.norm_eps)
        self.conv_out = InflatedConv(boc[0], cfg.out_channels, 3, padding=1)

    def make_pab_collect_cache(self, skip=(), kinds=None):
        """The empty cache structure for Pyramid Attention Broadcast (JAX
        ``models/unet_video.py:52-100``): passed as ``attn_cache``, the
        forward computes and returns the attention deltas of every
        transformer block. Levels named in ``skip`` (``down_i``, ``mid``,
        ``up_i``) are left out and recompute every step. ``kinds`` (a subset
        of cross, spatial, temporal) restricts what is cached: each block
        gets a marker dict of its cacheable entries (``()`` each); ``None``
        gives ``{}``, which caches every entry."""
        cfg = self.config

        def block_marker(only_cross: bool):
            if kinds is None:
                return {}
            marker = {}
            if ("cross" if only_cross else "spatial") in kinds:
                marker["attn1"] = ()
            if "cross" in kinds:
                marker["attn2"] = ()
            if "temporal" in kinds:
                marker["attn_temporal"] = ()
            return marker

        skip = set(skip)
        cache = {}
        for i, kind in enumerate(cfg.down_block_types):
            if kind == "CrossAttnDownBlock3D" and f"down_{i}" not in skip:
                cache[f"down_{i}"] = tuple((block_marker(cfg.only_cross_attention[i]),)
                                           for _ in range(cfg.layers_per_block))
        if "mid" not in skip:
            cache["mid"] = ((block_marker(False),),)
        only_cross_up = list(reversed(cfg.only_cross_attention))
        for i, kind in enumerate(cfg.up_block_types):
            if kind == "CrossAttnUpBlock3D" and f"up_{i}" not in skip:
                cache[f"up_{i}"] = tuple((block_marker(only_cross_up[i]),)
                                         for _ in range(cfg.layers_per_block + 1))
        return cache

    def _block(self, block, *args):
        """``block(*args)``, rematerialised under :attr:`use_remat` when
        autograd records."""
        if self.use_remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, sample, timestep, low_res, encoder_hidden_states, class_labels,
                attn_cache=None, use_flags=None, cfg_dup: bool = False):
        """sample (B, T, H, W, 4), low_res (B, T, H, W, 3), encoder_hidden_states
        (B', S, C_txt). With ``cfg_dup`` the caller passes sample/low_res at
        batch n and the context at 2n as [uncond, cond]: the text-free prefix
        runs once and is duplicated before the first text-consuming block
        (exactly as the reference's ``cfg_dup``). Returns (B', T, H, W, 4);
        with ``attn_cache`` (:meth:`make_pab_collect_cache`, or the caches a
        previous call returned) and ``use_flags`` ({cross, spatial, temporal}:
        bool), (output, new caches) as JAX's ``:105-330``."""
        cfg = self.config
        dt = self.conv_in.weight.dtype
        x = torch.cat([sample, low_res], dim=-1).to(dt)
        b = x.shape[0]
        if cfg_dup and encoder_hidden_states.shape[0] != 2 * b:
            raise ValueError("cfg_dup expects the context at twice the sample batch")
        tiled = not cfg_dup
        dup = lambda v: torch.cat([v, v], dim=0)

        ts = _per_row(timestep, b, x.device)
        emb = self.time_embedding(
            get_timestep_embedding(ts, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                   cfg.freq_shift).to(dt))
        if self.class_embedding is not None:
            labels = _per_row(class_labels, b, x.device)
            emb = emb + self.class_embedding(labels.long())
        ctx = encoder_hidden_states.to(dt)
        new_cache = {}

        x = self.conv_in(x)
        res = (x,)
        for i, block in enumerate(self.down_blocks):
            if isinstance(block, CrossAttnDownBlock3D):
                if not tiled:
                    x, emb, res, tiled = dup(x), dup(emb), tuple(dup(r) for r in res), True
                if attn_cache is not None and f"down_{i}" in attn_cache:
                    x, states, new_cache[f"down_{i}"] = self._block(
                        block, x, emb, ctx, attn_cache[f"down_{i}"], use_flags)
                else:
                    x, states = self._block(block, x, emb, ctx)
            else:
                x, states = self._block(block, x, emb)
            res += states
            if str(i) in self.down_temp_blocks:
                x = self._block(self.down_temp_blocks[str(i)], x, emb)

        if not tiled:
            x, emb, res = dup(x), dup(emb), tuple(dup(r) for r in res)
        if attn_cache is not None and "mid" in attn_cache:
            x, new_cache["mid"] = self._block(self.mid_block, x, emb, ctx, attn_cache["mid"],
                                              use_flags)
        else:
            x = self._block(self.mid_block, x, emb, ctx)
        if self.mid_temp_block is not None:
            x = self._block(self.mid_temp_block, x, emb)

        n = len(self.up_blocks)
        for i, block in enumerate(self.up_blocks):
            k = len(block.resnets)
            states, res = res[-k:], res[:-k]
            size = tuple(res[-1].shape[2:4]) if i != n - 1 and res else None
            if isinstance(block, CrossAttnUpBlock3D) and attn_cache is not None \
                    and f"up_{i}" in attn_cache:
                x, new_cache[f"up_{i}"] = self._block(block, x, states, emb, ctx, size,
                                                      attn_cache[f"up_{i}"], use_flags)
            elif isinstance(block, CrossAttnUpBlock3D):
                x = self._block(block, x, states, emb, ctx, size)
            else:
                x = self._block(block, x, states, emb, size)
            if str(i) in self.up_temp_blocks:
                x = self._block(self.up_temp_blocks[str(i)], x, emb)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x if attn_cache is None else (x, new_cache)
