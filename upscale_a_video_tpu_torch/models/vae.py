"""The VAE's decode path (mirror of the decode half of
``upscale_a_video_tpu/models/vae.py``): post-quant 1×1 conv, conv_in, the
video VAE's LR-image condition (two ResnetBlock3DPlus on the raw LR frames,
fused into the decoder features by an SFT block weighted by ``w_lr``), mid
block with the spatial attention, three up stages (two ×2), GN → SiLU →
conv_out. The 3D VAE (``VaeConfig()``) has plain blocks and no condition;
the video VAE (``VIDEO_VAE``) has both. The encoder is a later slice of the
port."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import VaeConfig
from ..nn.blocks import FuseSFTBlock, GroupNorm, InflatedConv, ResnetBlock3DPlus
from ..nn.unet_blocks import UNetMidBlock3D, UpDecoderBlock3D


class Decoder(nn.Module):
    def __init__(self, config: VaeConfig):
        super().__init__()
        cfg = config
        boc = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.condition_img = cfg.condition_img
        self.conv_in = InflatedConv(cfg.latent_channels, boc[-1], 3, padding=1)
        if cfg.condition_img:
            cc, g32 = cfg.condition_channels, min(32, g)
            self.condition_in = nn.ModuleList([
                ResnetBlock3DPlus(3, cc, None, groups=3, groups_out=g),
                ResnetBlock3DPlus(cc, cc, None, groups=g32, groups_out=g32)])
            self.condition_fuse = FuseSFTBlock(cc, boc[-1], g32)
        self.mid_block = UNetMidBlock3D(boc[-1], resnet_eps=1e-6, resnet_groups=g,
                                        plus=cfg.is_plus)
        rev = list(reversed(boc))
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i in range(len(boc)):
            prev, out_ch = out_ch, rev[i]
            self.up_blocks.append(UpDecoderBlock3D(prev, out_ch, cfg.layers_per_block + 1,
                                                   1e-6, g, add_upsample=i != len(boc) - 1,
                                                   plus=cfg.is_plus))
        self.conv_norm_out = GroupNorm(g, boc[0], 1e-6)
        self.conv_out = InflatedConv(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor, img: Optional[torch.Tensor] = None,
                w_lr: float = 1.0) -> torch.Tensor:
        x = self.conv_in(z)
        if self.condition_img:
            if img is None:
                raise ValueError("this decoder is conditioned on the LR frames: pass img")
            cond = img
            for block in self.condition_in:
                cond = block(cond)
            x = self.condition_fuse(cond, x, w_lr)
        x = self.mid_block(x)
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKLVideo(nn.Module):
    def __init__(self, config: VaeConfig = VaeConfig()):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = InflatedConv(config.latent_channels, config.latent_channels, 1)

    def decode(self, z: torch.Tensor, img: Optional[torch.Tensor] = None,
               w_lr: float = 1.0) -> torch.Tensor:
        """z: (B, T, h, w, latent) → (B, T, 4h, 4w, 3); img: the LR frames
        (B, T, h, w, 3) where the config conditions on them."""
        dt = self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv(z.to(dt)), None if img is None else img.to(dt),
                            w_lr)
