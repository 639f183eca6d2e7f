"""Temporal adapter after every UNet block (mirror of
``upscale_a_video_tpu/nn/temporal.py::TemporalModule3D``, released config):
a (5,1,1) temporal resblock, a spatial resblock and a 1×1 ``shift_conv``
residual gate, ``out = x + f(x) * w``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .blocks import InflatedConv, ResnetBlock3D, ResnetBlock3DCNN


class TemporalModule3D(nn.Module):
    def __init__(self, in_channels: int, temb_channels: Optional[int] = None, groups: int = 32):
        super().__init__()
        self.resblocks_3d_temporal = ResnetBlock3DCNN(
            in_channels, temb_channels=temb_channels, groups=groups, groups_out=groups,
            temporal_kernel=(5, 1, 1))
        self.resblocks_3d_spatial = ResnetBlock3D(in_channels, temb_channels=temb_channels,
                                                  groups=groups, groups_out=groups)
        self.shift_conv = InflatedConv(in_channels, in_channels, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                w: float = 1.0) -> torch.Tensor:
        h = self.resblocks_3d_temporal(x, temb)
        h = self.resblocks_3d_spatial(h, temb)
        return x + self.shift_conv(h) * w
