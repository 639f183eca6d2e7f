"""UNet down/mid/up blocks and the VAE's encoder, mid and decoder blocks
(mirror of ``upscale_a_video_tpu/nn/unet_blocks.py``). The cross-attention
blocks take the Pyramid Attention Broadcast caches as JAX does
(``attn_caches``: one entry per attention, ``use_flags``) and then also
return the new caches."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .attention import SpatialAttentionBlock, Transformer3DModel
from .blocks import Downsample3D, ResnetBlock3D, ResnetBlock3DPlus, Upsample3D


def _attend(attn, x, context, attn_caches, i, use_flags, caches):
    """``attn(x, context)``; with caches, the i-th cache in and its new one
    appended to ``caches``."""
    if attn_caches is None:
        return attn(x, context)
    x, cache = attn(x, context, attn_caches[i], use_flags)
    caches.append(cache)
    return x


class CrossAttnDownBlock3D(nn.Module):
    def __init__(self, in_channels, out_channels, temb_channels, num_layers=2, resnet_eps=1e-5,
                 resnet_groups=32, attn_num_head_channels=8, cross_attention_dim=1024,
                 add_downsample=True, only_cross_attention=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                          groups=resnet_groups, eps=resnet_eps) for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer3DModel(attn_num_head_channels, out_channels // attn_num_head_channels,
                               out_channels, cross_attention_dim=cross_attention_dim,
                               norm_num_groups=resnet_groups,
                               only_cross_attention=only_cross_attention)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample3D(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, context, attn_caches=None, use_flags=None):
        states, caches = (), []
        for i, (resnet, attn) in enumerate(zip(self.resnets, self.attentions)):
            x = _attend(attn, resnet(x, temb), context, attn_caches, i, use_flags, caches)
            states += (x,)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states += (x,)
        return (x, states) if attn_caches is None else (x, states, tuple(caches))


class DownBlock3D(nn.Module):
    def __init__(self, in_channels, out_channels, temb_channels, num_layers=2, resnet_eps=1e-5,
                 resnet_groups=32, add_downsample=True):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                          groups=resnet_groups, eps=resnet_eps) for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample3D(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb):
        states = ()
        for resnet in self.resnets:
            x = resnet(x, temb)
            states += (x,)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states += (x,)
        return x, states


class UNetMidBlock3DCrossAttn(nn.Module):
    def __init__(self, in_channels, temb_channels, num_layers=1, resnet_eps=1e-5,
                 resnet_groups=32, attn_num_head_channels=8, cross_attention_dim=1024):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels, in_channels, temb_channels, groups=resnet_groups,
                          eps=resnet_eps) for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([
            Transformer3DModel(attn_num_head_channels, in_channels // attn_num_head_channels,
                               in_channels, cross_attention_dim=cross_attention_dim,
                               norm_num_groups=resnet_groups) for _ in range(num_layers)])

    def forward(self, x, temb, context, attn_caches=None, use_flags=None):
        x, caches = self.resnets[0](x, temb), []
        for i, (attn, resnet) in enumerate(zip(self.attentions, self.resnets[1:])):
            x = resnet(_attend(attn, x, context, attn_caches, i, use_flags, caches), temb)
        return x if attn_caches is None else (x, tuple(caches))


class _UpBlock(nn.Module):
    def __init__(self, in_channels, out_channels, prev_output_channel, temb_channels,
                 num_layers, resnet_eps, resnet_groups, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList()
        for i in range(num_layers):
            skip = in_channels if i == num_layers - 1 else out_channels
            cin = prev_output_channel if i == 0 else out_channels
            self.resnets.append(ResnetBlock3D(cin + skip, out_channels, temb_channels,
                                              groups=resnet_groups, eps=resnet_eps))
        self.upsamplers = nn.ModuleList([Upsample3D(out_channels)]) if add_upsample else None


class CrossAttnUpBlock3D(_UpBlock):
    def __init__(self, in_channels, out_channels, prev_output_channel, temb_channels,
                 num_layers=3, resnet_eps=1e-5, resnet_groups=32, attn_num_head_channels=8,
                 cross_attention_dim=1024, add_upsample=True, only_cross_attention=False):
        super().__init__(in_channels, out_channels, prev_output_channel, temb_channels,
                         num_layers, resnet_eps, resnet_groups, add_upsample)
        self.attentions = nn.ModuleList([
            Transformer3DModel(attn_num_head_channels, out_channels // attn_num_head_channels,
                               out_channels, cross_attention_dim=cross_attention_dim,
                               norm_num_groups=resnet_groups,
                               only_cross_attention=only_cross_attention)
            for _ in range(num_layers)])

    def forward(self, x, res_states: Tuple[torch.Tensor, ...], temb, context,
                upsample_size: Optional[Tuple[int, int]] = None, attn_caches=None,
                use_flags=None):
        caches = []
        for i, (resnet, attn) in enumerate(zip(self.resnets, self.attentions)):
            x = torch.cat([x, res_states[-1]], dim=-1)
            res_states = res_states[:-1]
            x = _attend(attn, resnet(x, temb), context, attn_caches, i, use_flags, caches)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, upsample_size)
        return x if attn_caches is None else (x, tuple(caches))


class UpBlock3D(_UpBlock):
    def __init__(self, in_channels, out_channels, prev_output_channel, temb_channels,
                 num_layers=3, resnet_eps=1e-5, resnet_groups=32, add_upsample=True):
        super().__init__(in_channels, out_channels, prev_output_channel, temb_channels,
                         num_layers, resnet_eps, resnet_groups, add_upsample)

    def forward(self, x, res_states, temb, upsample_size=None):
        for resnet in self.resnets:
            x = torch.cat([x, res_states[-1]], dim=-1)
            res_states = res_states[:-1]
            x = resnet(x, temb)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, upsample_size)
        return x


class UNetMidBlock3D(nn.Module):
    """VAE mid block: resnet → (spatial attention → resnet) × num_layers;
    ``plus=True`` takes ResnetBlock3DPlus (UNetMidBlock3D_plus)."""

    def __init__(self, in_channels, num_layers=1, resnet_eps=1e-6, resnet_groups=32,
                 attn_num_head_channels=None, plus=False):
        super().__init__()
        block = ResnetBlock3DPlus if plus else ResnetBlock3D
        self.resnets = nn.ModuleList([
            block(in_channels, in_channels, None, groups=resnet_groups, eps=resnet_eps)
            for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([
            SpatialAttentionBlock(in_channels, attn_num_head_channels, resnet_groups, resnet_eps)
            for _ in range(num_layers)])

    def forward(self, x):
        x = self.resnets[0](x)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = resnet(attn(x))
        return x


class DownEncoderBlock3D(nn.Module):
    """VAE encoder stage (ref unet_blocks.py:748-805): resnets, then a
    stride-2 conv unless it is the last stage."""

    def __init__(self, in_channels, out_channels, num_layers=2, resnet_eps=1e-6,
                 resnet_groups=32, add_downsample=True, downsample_padding=0):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels, None,
                          groups=resnet_groups, eps=resnet_eps) for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample3D(out_channels, downsample_padding)])
                             if add_downsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock3D(nn.Module):
    """VAE decoder stage; ``plus=True`` takes ResnetBlock3DPlus
    (UpDecoderBlock3D_plus)."""

    def __init__(self, in_channels, out_channels, num_layers=3, resnet_eps=1e-6,
                 resnet_groups=32, add_upsample=True, plus=False):
        super().__init__()
        block = ResnetBlock3DPlus if plus else ResnetBlock3D
        self.resnets = nn.ModuleList([
            block(in_channels if i == 0 else out_channels, out_channels, None,
                  groups=resnet_groups, eps=resnet_eps) for i in range(num_layers)])
        self.upsamplers = nn.ModuleList([Upsample3D(out_channels)]) if add_upsample else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x
