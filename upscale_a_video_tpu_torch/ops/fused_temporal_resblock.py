"""Temporal resblock ``x + conv2(silu(gn2(conv1(silu(gn1(x))) + b1 + temb))) + b2``
with (k,1,1) and (3,1,1) temporal convs, on the card in five launches.

Replaces ``upscale_a_video_tpu/ops/fused_temporal_resblock.py::
fused_temporal_resblock`` (Pallas K1 and K2); the CUDA kernels are in
``csrc/fused_temporal_resblock.cu`` (its statistics and conv kernels are
shared with ``fused_groupnorm`` and ``temporal_conv``). GroupNorm statistics
reduce over (T, H, W, C/G) per sample, torch's 5-D GroupNorm.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda
from .temporal_conv import PIXELS, temporal_conv_plain


def gn_affine(x: torch.Tensor, weight, bias, groups: int, eps: float):
    """GroupNorm over all non-channel axes of each sample, folded into
    y = x·a + d with a, d: (B, C) fp32."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf * xf).mean(dim=(1, 3)) - mean * mean
    rstd = torch.rsqrt(var + eps)
    w = weight.float().reshape(groups, c // groups)
    a = (rstd[:, :, None] * w).reshape(b, c)
    d = (bias.float().reshape(groups, c // groups) - (mean * rstd)[:, :, None] * w).reshape(b, c)
    return a, d


def fused_temporal_resblock_plain(x, n1_w, n1_b, w1, b1, temb_proj, n2_w, n2_b, w2, b2,
                                  groups: int, eps: float = 1e-6,
                                  groups2: Optional[int] = None):
    g2 = groups2 or groups
    dt = x.dtype

    def gn(v, w, b, g):
        a, d = gn_affine(v, w, b, g, eps)
        return (v.float() * a[:, None, None, None, :] + d[:, None, None, None, :]).to(dt)

    h = F.silu(gn(x, n1_w, n1_b, groups))
    h = temporal_conv_plain(h, w1, b1)
    if temb_proj is not None:
        h = h + temb_proj[:, None, None, None, :].to(dt)
    h = F.silu(gn(h, n2_w, n2_b, g2))
    h = temporal_conv_plain(h, w2, b2)
    return x + h


def fused_resblock_fits(x: torch.Tensor, groups: int, groups2: Optional[int] = None) -> bool:
    b, t, h, w, c = x.shape
    g2 = groups2 or groups
    return (x.dtype == torch.bfloat16 and c % 16 == 0 and c <= 512 and c % groups == 0
            and c % g2 == 0 and 1 <= t <= 8 and (h * w) % PIXELS == 0)


def _gn_on_card(lib, src, part, nblk, weight, bias, groups, count, eps, stream):
    b, c = src.shape[0], src.shape[-1]
    a = torch.empty(b, c, device=src.device, dtype=torch.float32)
    d = torch.empty_like(a)
    wt = _cuda.operand(weight, torch.bfloat16, "gn weight")
    bs = _cuda.operand(bias, torch.bfloat16, "gn bias")
    _cuda.check(lib.uav_gn_finalize(part.data_ptr(), wt.data_ptr(), bs.data_ptr(), a.data_ptr(),
                                    d.data_ptr(), b, nblk, c, groups, float(count), float(eps),
                                    stream), "gn_finalize")
    return a, d


def _taps(w: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (Co, Ci, k, 1, 1) → (k, Co, Ci), tap-major."""
    return _cuda.operand(w[..., 0, 0].permute(2, 0, 1), torch.bfloat16, "conv weight")


def fused_temporal_resblock(x, n1_w, n1_b, w1, b1, temb_proj, n2_w, n2_b, w2, b2, *,
                            groups: int, groups2: Optional[int] = None, eps: float = 1e-6):
    """x: (B, T, H, W, C); w1: (C, C, k, 1, 1); w2: (C, C, 3, 1, 1);
    temb_proj: (B, C) or None. Matches ``_ResnetCore`` with the temporal
    convs and in == out channels (ref resnet.py:297-393)."""
    if not x.is_cuda:
        return fused_temporal_resblock_plain(x, n1_w, n1_b, w1, b1, temb_proj, n2_w, n2_b,
                                             w2, b2, groups, eps, groups2)
    g2 = groups2 or groups
    b, t, hh, ww, c = x.shape
    hw = hh * ww
    if not fused_resblock_fits(x, groups, g2):
        raise ValueError(f"fused_temporal_resblock: unsupported shape {tuple(x.shape)}")
    lib = _cuda.lib()
    stream = _cuda.stream_ptr(x.device)
    xf = _cuda.operand(x, torch.bfloat16, "x")
    rows = t * hw
    nblk1 = max(1, min(256, rows // 64))
    part1 = torch.empty(b, nblk1, c, 2, device=x.device, dtype=torch.float32)
    _cuda.check(lib.uav_gn_partials(xf.data_ptr(), part1.data_ptr(), b, rows, c, nblk1, stream),
                "gn_partials")
    a1, d1 = _gn_on_card(lib, xf, part1, nblk1, n1_w, n1_b, groups, rows * (c // groups), eps,
                         stream)
    temb = None if temb_proj is None else _cuda.operand(temb_proj.float(), torch.float32, "temb")
    w1t, w2t = _taps(w1), _taps(w2)
    b1t = _cuda.operand(b1, torch.bfloat16, "b1")
    b2t = _cuda.operand(b2, torch.bfloat16, "b2")
    nblk2 = hw // PIXELS
    h1 = torch.empty_like(xf)
    part2 = torch.empty(b, nblk2, c, 2, device=x.device, dtype=torch.float32)
    _cuda.check(lib.uav_temporal_conv(xf.data_ptr(), a1.data_ptr(), d1.data_ptr(),
                                      w1t.data_ptr(), w1t.shape[0], b1t.data_ptr(),
                                      _cuda.ptr(temb), None, h1.data_ptr(), part2.data_ptr(),
                                      b, t, hw, c, stream), "temporal_conv (K1)")
    a2, d2 = _gn_on_card(lib, xf, part2, nblk2, n2_w, n2_b, g2, rows * (c // g2), eps, stream)
    out = torch.empty_like(xf)
    _cuda.check(lib.uav_temporal_conv(h1.data_ptr(), a2.data_ptr(), d2.data_ptr(),
                                      w2t.data_ptr(), w2t.shape[0], b2t.data_ptr(), None,
                                      xf.data_ptr(), out.data_ptr(), None, b, t, hw, c, stream),
                "temporal_conv (K2)")
    _cuda.count("fused_temporal_resblock", (b, t, hh, ww, c, w1.shape[2]))
    return out
