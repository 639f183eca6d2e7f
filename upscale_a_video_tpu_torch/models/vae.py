"""The released 3D VAE, decode path (mirror of the decode half of
``upscale_a_video_tpu/models/vae.py``): post-quant 1×1 conv, conv_in, mid
block with the spatial attention, three up stages (two ×2), GN → SiLU →
conv_out. The encoder and the video VAE's conditional decoder are later
slices of the port."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import VaeConfig
from ..nn.blocks import GroupNorm, InflatedConv
from ..nn.unet_blocks import UNetMidBlock3D, UpDecoderBlock3D


class Decoder(nn.Module):
    def __init__(self, config: VaeConfig):
        super().__init__()
        cfg = config
        boc = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = InflatedConv(cfg.latent_channels, boc[-1], 3, padding=1)
        self.mid_block = UNetMidBlock3D(boc[-1], resnet_eps=1e-6, resnet_groups=g)
        rev = list(reversed(boc))
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i in range(len(boc)):
            prev, out_ch = out_ch, rev[i]
            self.up_blocks.append(UpDecoderBlock3D(prev, out_ch, cfg.layers_per_block + 1,
                                                   1e-6, g, add_upsample=i != len(boc) - 1))
        self.conv_norm_out = GroupNorm(g, boc[0], 1e-6)
        self.conv_out = InflatedConv(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKLVideo(nn.Module):
    def __init__(self, config: VaeConfig = VaeConfig()):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = InflatedConv(config.latent_channels, config.latent_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T, h, w, latent) → (B, T, 4h, 4w, 3)."""
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))
