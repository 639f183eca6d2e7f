"""The conditional video VAE (mirror of ``upscale_a_video_tpu/models/vae.py``).

Encoder: conv_in, three down stages (two stride-2, bottom/right padded),
mid block with the spatial attention, GN → SiLU → conv_out to the Gaussian
moments, then the 1×1 ``quant_conv``. Decoder: post-quant 1×1 conv, conv_in,
the video VAE's LR-image condition (two ResnetBlock3DPlus on the raw LR
frames, fused into the decoder features by an SFT block weighted by
``w_lr``), mid block, three up stages (two ×2), GN → SiLU → conv_out. The 3D
VAE (``VaeConfig()``) has plain blocks and no condition; the video VAE
(``VIDEO_VAE``) has both. Both carry the encoder, as the released bundle
does."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import VaeConfig
from ..nn.blocks import FuseSFTBlock, GroupNorm, InflatedConv, ResnetBlock3DPlus
from ..nn.unet_blocks import DownEncoderBlock3D, UNetMidBlock3D, UpDecoderBlock3D


class Encoder(nn.Module):
    """(B, T, H, W, 3) → (B, T, H/4, W/4, 2·latent) moments (ref
    vae_video.py:55-156)."""

    def __init__(self, config: VaeConfig):
        super().__init__()
        cfg = config
        boc = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = InflatedConv(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        out_ch = boc[0]
        for i in range(len(cfg.down_block_types)):
            prev, out_ch = out_ch, boc[i]
            self.down_blocks.append(DownEncoderBlock3D(
                prev, out_ch, cfg.layers_per_block, 1e-6, g,
                add_downsample=i != len(boc) - 1, downsample_padding=0))
        self.mid_block = UNetMidBlock3D(boc[-1], resnet_eps=1e-6, resnet_groups=g)
        self.conv_norm_out = GroupNorm(g, boc[-1], 1e-6)
        self.conv_out = InflatedConv(boc[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


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


class DiagonalGaussianDistribution:
    """The encoder's posterior (ref vae_video.py:407-451): moments split on
    the last axis into mean and log-variance (clipped to [-30, 20])."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.parameters = parameters
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std · noise, the noise given or drawn from ``generator``."""
        if self.deterministic:
            return self.mean
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None) -> torch.Tensor:
        dims = tuple(range(1, self.mean.ndim))
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], device=self.mean.device)
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum((self.mean - other.mean) ** 2 / other.var + self.var / other.var
                               - 1.0 - self.logvar + other.logvar, dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(float(np.log(2.0 * np.pi)) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=dims)


class AutoencoderKLVideo(nn.Module):
    def __init__(self, config: VaeConfig = VaeConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = InflatedConv(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = InflatedConv(config.latent_channels, config.latent_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) → (B, T, H/4, W/4, 2·latent) Gaussian moments."""
        return self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        return DiagonalGaussianDistribution(self.encode_moments(x))

    def decode(self, z: torch.Tensor, img: Optional[torch.Tensor] = None,
               w_lr: float = 1.0) -> torch.Tensor:
        """z: (B, T, h, w, latent) → (B, T, 4h, 4w, 3); img: the LR frames
        (B, T, h, w, 3) where the config conditions on them."""
        dt = self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv(z.to(dt)), None if img is None else img.to(dt),
                            w_lr)
