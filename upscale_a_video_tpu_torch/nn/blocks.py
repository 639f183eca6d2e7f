"""Core blocks on channels-last ``(B, T, H, W, C)`` video tensors.

Mirror of ``upscale_a_video_tpu/nn/blocks.py`` (decode-path subset). Module
and parameter names are the reference's torch names, so the reference's
state dicts load with ``strict=True``. The 2-D convolutions and linears stay
on PyTorch's own ``conv2d``/``linear``, as the reference left them to XLA;
the temporal resblock goes to the fused kernel where its gate holds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.fused_feedforward import layer_norm
from ..ops.fused_groupnorm import fused_group_norm, fused_group_norm_fits, group_norm_plain
from ..ops.fused_temporal_resblock import fused_resblock_fits, fused_temporal_resblock


class GroupNorm(nn.Module):
    """GroupNorm over every non-channel axis of each sample (channels last),
    fp32 statistics, result in the input dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, g = x.shape[0], x.shape[-1], self.num_groups
        xg = x.float().reshape(n, -1, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean
        y = (xg - mean) * torch.rsqrt(var + self.eps)
        y = y.reshape(n, -1, c) * self.weight.float() + self.bias.float()
        return y.to(x.dtype).reshape(x.shape)


class FusedGroupNorm(nn.Module):
    """GroupNorm (+ SiLU with ``act="silu"``) through the fused GroupNorm
    kernel where its gate holds (ref ``nn/blocks.py:57-83``). As in the JAX
    package no model uses it: the resblocks keep :class:`GroupNorm`."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _cuda.route(x, fused_group_norm_fits(x, self.num_groups, self.act)):
            return fused_group_norm(x, self.weight, self.bias, self.num_groups, self.eps,
                                    self.act)
        return group_norm_plain(x, self.weight, self.bias, self.num_groups, self.eps, self.act)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class InflatedConv(nn.Conv2d):
    """Per-frame 2-D convolution (ref InflatedConv3d, resnet.py:94-101)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        y = F.conv2d(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1).reshape(b, t, *y.shape[2:], y.shape[1])


class TemporalConv(nn.Conv3d):
    """3-D convolution over (T, H, W) with a (k,1,1) or 1×1×1 kernel."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int]):
        super().__init__(cin, cout, kernel, padding=tuple((k - 1) // 2 for k in kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight, self.bias, padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class Upsample3D(nn.Module):
    """Nearest upsample (×2, or to a forced ``output_size``) then 3×3 conv
    (ref resnet.py:104-158). The reference's folded sub-pixel emission of
    the ×2 case is a TPU layout choice; this is the same function."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None):
        b, t, h, w, c = x.shape
        nh, nw = (2 * h, 2 * w) if output_size is None else tuple(output_size)
        if (nh, nw) == (2 * h, 2 * w):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        else:
            rows = torch.arange(nh, device=x.device) * h // nh
            cols = torch.arange(nw, device=x.device) * w // nw
            x = x[:, :, rows][:, :, :, cols]
        return self.conv(x)


class Downsample3D(nn.Module):
    """Stride-2 3×3 conv (ref resnet.py:161-197): ``padding=1`` pads both
    sides (the UNet), ``padding=0`` pads only bottom and right by one (the VAE
    encoder's ``downsample_padding=0``)."""

    def __init__(self, channels: int, padding: int = 1):
        super().__init__()
        self.pad_end = padding == 0
        self.conv = InflatedConv(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_end:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class _ResnetCore(nn.Module):
    """GN → SiLU → conv → (+temb) → GN → SiLU → conv (+ shortcut)
    (ref resnet.py:200-393). ``temporal`` selects the 3DCNN variant whose
    conv1 is (k,1,1) and conv2 (3,1,1); with in == out channels it is the
    fused temporal resblock."""

    temporal = False

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 512, groups: int = 32,
                 groups_out: Optional[int] = None, eps: float = 1e-6,
                 temporal_kernel: Tuple[int, int, int] = (3, 1, 1)):
        super().__init__()
        out = out_channels or in_channels
        self.in_channels, self.out_channels = in_channels, out
        self.groups, self.groups_out, self.eps = groups, groups_out or groups, eps
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.norm2 = GroupNorm(self.groups_out, out, eps)
        if self.temporal:
            self.conv1 = TemporalConv(in_channels, out, temporal_kernel)
            self.conv2 = TemporalConv(out, out, (3, 1, 1))
        else:
            self.conv1 = InflatedConv(in_channels, out, 3, padding=1)
            self.conv2 = InflatedConv(out, out, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out) if temb_channels else None
        if in_channels != out:
            self.conv_shortcut = (TemporalConv(in_channels, out, (1, 1, 1)) if self.temporal
                                  else InflatedConv(in_channels, out, 1))
        else:
            self.conv_shortcut = None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        temb_proj = None
        if temb is not None and self.time_emb_proj is not None:
            temb_proj = self.time_emb_proj(F.silu(temb))
        if (self.temporal and self.conv_shortcut is None
                and _cuda.route(x, fused_resblock_fits(x, self.groups, self.groups_out))):
            return fused_temporal_resblock(
                x, self.norm1.weight, self.norm1.bias, self.conv1.weight, self.conv1.bias,
                temb_proj, self.norm2.weight, self.norm2.bias, self.conv2.weight,
                self.conv2.bias, groups=self.groups, groups2=self.groups_out, eps=self.eps)
        h = self.conv1(F.silu(self.norm1(x)))
        if temb_proj is not None:
            h = h + temb_proj[:, None, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class ResnetBlock3D(_ResnetCore):
    """Spatial resblock with per-frame 3×3 convs (ref resnet.py:200-294)."""


class ResnetBlock3DCNN(_ResnetCore):
    """Temporal resblock with (k,1,1) convs (ref resnet.py:297-393)."""

    temporal = True


class ResnetBlock3DPlus(ResnetBlock3D):
    """Spatial resblock plus a GroupNorm → SiLU → (3,3,3) conv residual
    branch, zero-initialised in the reference (ref resnet.py:396-499). Used
    by the video VAE's decoder blocks."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 512, groups: int = 32,
                 groups_out: Optional[int] = None, eps: float = 1e-6):
        super().__init__(in_channels, out_channels, temb_channels, groups, groups_out, eps)
        self.norm_3d = GroupNorm(self.groups_out, self.out_channels, eps)
        self.conv_3d = TemporalConv(self.out_channels, self.out_channels, (3, 3, 3))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = super().forward(x, temb)
        return out + self.conv_3d(F.silu(self.norm_3d(out)))


class FuseSFTBlock(nn.Module):
    """SFT fusion of the LR-condition features into the decoder features
    (ref resnet.py:63-79): two resblocks on concat(enc, dec), then a learned
    scale and shift applied to ``dec`` with weight ``w``."""

    def __init__(self, enc_channels: int, dec_channels: int, groups: int = 32):
        super().__init__()
        self.shared = nn.ModuleList([
            ResnetBlock3D(enc_channels + dec_channels, dec_channels, None, groups, groups),
            ResnetBlock3D(dec_channels, dec_channels, None, groups, groups)])
        self.scale = InflatedConv(dec_channels, dec_channels, 3, padding=1)
        self.shift = InflatedConv(dec_channels, dec_channels, 3, padding=1)

    def forward(self, enc_feat: torch.Tensor, dec_feat: torch.Tensor,
                w: float = 1.0) -> torch.Tensor:
        h = torch.cat([enc_feat, dec_feat], dim=-1)
        for block in self.shared:
            h = block(h)
        return dec_feat + w * (dec_feat * self.scale(h) + self.shift(h))
