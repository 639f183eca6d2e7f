"""Learnable flow-guided propagation (mirror of
``upscale_a_video_tpu/models/propagation_learnable.py``; ref
propagation_module.py:158-281, the ``learnable=True`` branch).

Per direction a ``DeformableAlignment`` (a modulated DCN whose offsets are
the resized flow plus a bounded tanh residual predicted from [current,
warped, flow, consistency mask], ref :333-372) and a ``ConvResidualBlocks``
backbone refining [current, propagated] (ref :257-259); then a fuse of
[input, backward, forward] features with a residual (ref :271-277). The
frame recurrence is a Python loop; the DCN is ``ops.deform_conv``. Module
names are the reference's (``weights.propagator_state_dict`` converts a JAX
tree).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import TemporalConv
from ..ops.deform_conv import deform_conv2d
from ..ops.warp import flow_warp
from .propagation import _resize_flows, fb_consistency_check


class _Conv(nn.Conv2d):
    """3×3 SAME conv on channels-last (B, H, W, C)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                        padding=1).permute(0, 2, 3, 1)


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))) (ref :59-83)."""

    def __init__(self, num_feat: int = 64):
        super().__init__()
        self.conv1, self.conv2 = _Conv(num_feat, num_feat), _Conv(num_feat, num_feat)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class ConvResidualBlocks(nn.Module):
    """conv + LeakyReLU(0.1) + residual blocks (ref :85-101)."""

    def __init__(self, num_in_ch: int, num_out_ch: int = 64, num_blocks: int = 2):
        super().__init__()
        self.main = nn.Sequential(
            _Conv(num_in_ch, num_out_ch), nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlockNoBN(num_out_ch) for _ in range(num_blocks)]))

    def forward(self, x):
        return self.main(x)


class DeformableAlignment(nn.Module):
    """Modulated DCN with flow-conditioned offsets (ref :333-372)."""

    def __init__(self, channels: int, deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0):
        super().__init__()
        c = channels
        self.max_residue_magnitude = max_residue_magnitude
        self.conv_offset = nn.Sequential(
            _Conv(2 * c + 3, c), nn.LeakyReLU(0.1), _Conv(c, c), nn.LeakyReLU(0.1),
            _Conv(c, c), nn.LeakyReLU(0.1), _Conv(c, 27 * deformable_groups))
        nn.init.zeros_(self.conv_offset[6].weight)
        nn.init.zeros_(self.conv_offset[6].bias)
        self.weight = nn.Parameter(torch.empty(c, c, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, cond_feat, flow):
        """x: (B, H, W, C); cond: (B, H, W, 2C + 3); flow: (B, H, W, 2), (x, y)."""
        o1, o2, mask = self.conv_offset(cond_feat).chunk(3, dim=-1)
        offset = self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2], dim=-1))
        flow_yx = torch.stack([flow[..., 1], flow[..., 0]], dim=-1)
        offset = offset + flow_yx.repeat(1, 1, 1, offset.shape[-1] // 2)
        return deform_conv2d(x, offset, self.weight, self.bias, padding=1,
                             mask=torch.sigmoid(mask))


class LearnablePropagation(nn.Module):
    """ref Propagation(learnable=True) forward (:194-281). x: (B, T, H, W, C);
    flows (B, T - 1, Hf, Wf, 2), resized to (H, W)."""

    DIRECTIONS = ("backward_prop", "forward_prop")

    def __init__(self, in_channels: int, mid_channels: int = 256, num_blocks: int = 2,
                 max_residue_magnitude: float = 10.0):
        super().__init__()
        self.in_channels, self.mid_channels = in_channels, mid_channels
        if mid_channels != in_channels:
            self.input_layer = TemporalConv(in_channels, mid_channels, (3, 1, 1))
            self.output_layer = TemporalConv(mid_channels, in_channels, (3, 1, 1))
        self.deform_align = nn.ModuleDict({
            m: DeformableAlignment(mid_channels, 16, max_residue_magnitude)
            for m in self.DIRECTIONS})
        self.backbone = nn.ModuleDict({
            m: ConvResidualBlocks(2 * mid_channels, mid_channels, num_blocks)
            for m in self.DIRECTIONS})
        self.fuse = ConvResidualBlocks(3 * mid_channels, mid_channels, 2)

    def _step(self, name, feat_prop, feat_current, flow_prop, flow_check, interpolation,
              alpha1, alpha2):
        mask = fb_consistency_check(flow_prop, flow_check, alpha1, alpha2)
        warped = flow_warp(feat_prop, flow_prop, interpolation=interpolation)
        cond = torch.cat([feat_current, warped, flow_prop, mask.to(feat_current.dtype)], dim=-1)
        feat_prop = self.deform_align[name](feat_prop, cond, flow_prop)
        return feat_prop + self.backbone[name](torch.cat([feat_current, feat_prop], dim=-1))

    def _run_pass(self, name, feats, flows_prop, flows_check, interpolation, alpha1, alpha2,
                  reverse):
        """One direction over the frames: the first frame refined by the
        backbone alone, then each next frame from the one before (backward:
        frames T-2 .. 0 with flows T-2 .. 0; forward: frames 1 .. T-1 with
        flows 0 .. T-2). (B, T, H, W, C) in frame order."""
        t = feats.shape[1]
        first = feats[:, -1] if reverse else feats[:, 0]
        prop = first + self.backbone[name](torch.cat([first, first], dim=-1))
        outs = [prop]
        for n in range(t - 1):
            frame, flow = (t - 2 - n, t - 2 - n) if reverse else (n + 1, n)
            prop = self._step(name, prop, feats[:, frame], flows_prop[:, flow],
                              flows_check[:, flow], interpolation, alpha1, alpha2)
            outs.append(prop)
        return torch.stack(outs[::-1] if reverse else outs, dim=1)

    def forward(self, x, flows_forward, flows_backward, interpolation: str = "bilinear",
                alpha1: float = 0.01, alpha2: float = 0.5):
        b, t, h, w, c = x.shape
        src_w = flows_forward.shape[3]
        ff = _resize_flows(flows_forward, (h, w), src_w)
        fb = _resize_flows(flows_backward, (h, w), src_w)
        x_orig = x
        if self.mid_channels != self.in_channels:
            x = self.input_layer(x)
        feats_b = self._run_pass("backward_prop", x, ff, fb, interpolation, alpha1, alpha2, True)
        feats_f = self._run_pass("forward_prop", feats_b, fb, ff, interpolation, alpha1, alpha2,
                                 False)
        cat = torch.cat([x, feats_b, feats_f], dim=-1)
        fused = self.fuse(cat.reshape(b * t, h, w, -1)).reshape(b, t, h, w, self.mid_channels)
        if self.mid_channels != self.in_channels:
            fused = self.output_layer(fused)
        return fused + x_orig
