"""Temporal adapters (mirror of ``upscale_a_video_tpu/nn/temporal.py``; ref
temporal_module.py:63-194).

``TemporalModule3D`` follows every UNet block. In the released config it is
purely convolutional: a (5,1,1) temporal resblock, a spatial resblock and a
zero-initialised 1×1 ``shift_conv`` residual gate, ``out = x + f(x) · w``.
Off the released config it can also run the temporal-transformer branch
(``attention_block_types``, :mod:`.temporal_transformer`) after the
resblocks, and end in a scale-and-shift of the input (``use_scale_shift``)
instead of the gate. ``TemporalModule3DVAE`` is the video VAE decoder's
variant, which the released decoder only flags.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .blocks import InflatedConv, ResnetBlock3D, ResnetBlock3DCNN
from .temporal_transformer import TemporalTransformer3DModel


class InflatedConvZero(InflatedConv):
    """A per-frame conv with zero-initialised weight and bias (residual
    gates), SAME padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, padding=kernel_size // 2)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class TemporalModule3D(nn.Module):
    def __init__(self, in_channels: int, temb_channels: Optional[int] = None, groups: int = 32,
                 use_scale_shift: bool = False, attention_block_types: Tuple[str, str] = ("", ""),
                 num_attention_heads: int = 8, attention_dim_div: int = 2,
                 cross_frame_attention_mode: Optional[str] = None, use_dcn_warpping: bool = False,
                 use_deformable_conv: bool = True):
        super().__init__()
        self.use_scale_shift = use_scale_shift
        self.resblocks_3d_temporal = ResnetBlock3DCNN(
            in_channels, temb_channels=temb_channels, groups=groups, groups_out=groups,
            temporal_kernel=(5, 1, 1))
        self.resblocks_3d_spatial = ResnetBlock3D(in_channels, temb_channels=temb_channels,
                                                  groups=groups, groups_out=groups)
        if any(attention_block_types):
            self.attentions = nn.ModuleList([TemporalTransformer3DModel(
                num_attention_heads, in_channels // num_attention_heads // attention_dim_div,
                in_channels, num_layers=1, norm_num_groups=min(8, groups),
                attention_block_types=tuple(attention_block_types),
                cross_frame_attention_mode=cross_frame_attention_mode,
                use_dcn_warpping=use_dcn_warpping, use_deformable_conv=use_deformable_conv)])
        else:
            self.attentions = None
        if use_scale_shift:
            self.scale_shift_conv = InflatedConv(in_channels, 2 * in_channels, 1)
        else:
            self.shift_conv = InflatedConvZero(in_channels, in_channels, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                w: float = 1.0, timesteps=None) -> torch.Tensor:
        h = self.resblocks_3d_temporal(x, temb)
        h = self.resblocks_3d_spatial(h, temb)
        if self.attentions is not None:
            h = self.attentions[0](h, timesteps if timesteps is not None else 0)
        if self.use_scale_shift:
            scale, shift = self.scale_shift_conv(h).chunk(2, dim=-1)
            return (1 + scale) * x + shift
        return x + self.shift_conv(h) * w


class TemporalModule3DVAE(nn.Module):
    """The video VAE decoder's temporal adapter (ref temporal_module.py:63-94):
    a (3,1,1) temporal resblock without time embedding, then a zero-init 3×3
    conv gate, ``out = x + f(x) · w``."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.resblocks_3d_temporal = ResnetBlock3DCNN(in_channels, temb_channels=None,
                                                      temporal_kernel=(3, 1, 1))
        self.resblocks_3d_spatial = InflatedConvZero(in_channels, in_channels, 3)

    def forward(self, x: torch.Tensor, w: float = 1.0) -> torch.Tensor:
        return x + self.resblocks_3d_spatial(self.resblocks_3d_temporal(x)) * w
