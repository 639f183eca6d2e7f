"""Temporal resblock ``x + conv2(silu(gn2(conv1(silu(gn1(x))) + b1 + temb))) + b2``
with (k,1,1) and (3,1,1) temporal convs, on the card in five launches.

Replaces ``upscale_a_video_tpu/ops/fused_temporal_resblock.py::
fused_temporal_resblock`` (Pallas K1 and K2); the CUDA kernels are in
``csrc/fused_temporal_resblock.cu``: both convs run on the GEMM core of
``csrc/gemm_core.cuh`` (shared with ``temporal_conv`` and the feed-forward)
with the GroupNorm + SiLU applied to the A operand in registers, and the
statistics kernels are shared with ``fused_groupnorm``. GroupNorm statistics
reduce over (T, H, W, C/G) per sample, torch's 5-D GroupNorm.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda
from .temporal_conv import taps_operand, temporal_conv_plain

BIG_TILE = (128, 256)  # the resblock convs' big tile (csrc/fused_temporal_resblock.cu)


def _fold(mean, var, weight, bias, eps: float):
    """Per-(sample, group) mean and variance, (B, G) fp32, and the affine →
    GroupNorm as y = x·a + d with a, d: (B, C) fp32."""
    b, groups = mean.shape
    c = weight.shape[0]
    rstd = torch.rsqrt(var + eps)
    w = weight.float().reshape(groups, c // groups)
    a = (rstd[:, :, None] * w).reshape(b, c)
    d = (bias.float().reshape(groups, c // groups) - (mean * rstd)[:, :, None] * w).reshape(b, c)
    return a, d


def gn_affine(x: torch.Tensor, weight, bias, groups: int, eps: float):
    """GroupNorm over all non-channel axes of each sample, folded into
    y = x·a + d with a, d: (B, C) fp32."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    return _fold(mean, (xf * xf).mean(dim=(1, 3)) - mean * mean, weight, bias, eps)


def tile_partials(h: torch.Tensor, hw: int, rows: int) -> torch.Tensor:
    """The first conv's GroupNorm-2 partials: h (B, T, R, C) with R ≥ hw
    rows per frame, of which rows past ``hw`` (the zero fill of the last
    tile, which holds bias + temb after the epilogue) are left out; per
    (sample, frame, tile of ``rows`` rows, channel) the sums of h and h²,
    (B, T·ceil(hw/rows), C, 2) fp32."""
    b, t, _, c = h.shape
    n = -(-hw // rows)
    hf = torch.zeros(b, t, n * rows, c, dtype=torch.float32, device=h.device)
    hf[:, :, :hw] = h[:, :, :hw].float()
    hf = hf.reshape(b, t * n, rows, c)
    return torch.stack([hf.sum(dim=2), (hf * hf).sum(dim=2)], dim=-1)


def gn_affine_from_partials(part: torch.Tensor, count: int, weight, bias, groups: int,
                            eps: float):
    """The finalize kernel's plain version: part (B, P, C, 2) of per-row-block
    sums of v and v² → the GroupNorm of v folded into y = v·a + d, a, d (B, C)
    fp32; ``count`` elements per (sample, group)."""
    b, _, c, _ = part.shape
    s = part.double().sum(dim=1).reshape(b, groups, c // groups, 2).sum(dim=2)
    mean = (s[..., 0] / count).float()
    return _fold(mean, (s[..., 1] / count).float() - mean * mean, weight, bias, eps)


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
    """bf16, C a multiple of 64 (the core's 64-channel slices) and of both
    group counts, C ≤ 512 (the widths the card check holds it at). Any T and
    any frame size: ragged tiles are TMA's zero fill, masked on store and in
    the GroupNorm sums."""
    c = x.shape[-1]
    g2 = groups2 or groups
    return (x.dtype == torch.bfloat16 and x.dim() == 5 and c % 64 == 0 and c <= 512
            and c % groups == 0 and c % g2 == 0)


def tile_rows(frames: int, hw: int, c: int, sms: int) -> int:
    """Rows of the convs' GEMM tile (``csrc/gemm_core.cuh::small_tiles``):
    64 for frames of at most 64 pixels or when fewer big tiles than the
    card's ``sms`` SMs cover the output, else 128. It sizes the first conv's
    GroupNorm partials, one per (tile, channel); the kernel refuses a
    disagreement."""
    big = frames * -(-hw // BIG_TILE[0]) * -(-c // BIG_TILE[1])
    return 64 if hw <= 64 or big < sms else BIG_TILE[0]


def partial_rows(t: int, hw: int, rows: int) -> int:
    """Partial-sum rows per sample that the first conv writes: one per frame
    and tile of ``rows`` rows."""
    return t * -(-hw // rows)


def _gn_on_card(lib, part, weight, bias, groups, count, eps, stream):
    """The finalize kernel on partial sums (B, P, C, 2): a / 2 and d / 2 of the
    GroupNorm, the halves the convs' prologue takes."""
    b, nblk, c, _ = part.shape
    a = torch.empty(b, c, device=part.device, dtype=torch.float32)
    d = torch.empty_like(a)
    wt = _cuda.weight(weight, torch.bfloat16, "gn weight")
    bs = _cuda.weight(bias, torch.bfloat16, "gn bias")
    _cuda.check(lib.uav_gn_finalize(part.data_ptr(), wt.data_ptr(), bs.data_ptr(), a.data_ptr(),
                                    d.data_ptr(), b, nblk, c, groups, float(count), float(eps),
                                    stream), "gn_finalize")
    return a, d


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
    xf = _cuda.tma_operand(x, "x")
    rows = t * hw
    nblk1 = max(1, min(256, rows // 64))
    part1 = torch.empty(b, nblk1, c, 2, device=x.device, dtype=torch.float32)
    _cuda.check(lib.uav_gn_partials(xf.data_ptr(), part1.data_ptr(), b, rows, c, nblk1, stream),
                "gn_partials")
    a1, d1 = _gn_on_card(lib, part1, n1_w, n1_b, groups, rows * (c // groups), eps, stream)
    temb = None if temb_proj is None else _cuda.operand(temb_proj.float(), torch.float32, "temb")
    w1t, w2t = taps_operand(w1, "conv1 weight"), taps_operand(w2, "conv2 weight")
    b1t = _cuda.weight(b1, torch.bfloat16, "b1")
    b2t = _cuda.weight(b2, torch.bfloat16, "b2")
    tm = tile_rows(b * t, hw, c, _cuda.sm_count(x.device))
    h1 = torch.empty_like(xf)
    part2 = torch.empty(b, partial_rows(t, hw, tm), c, 2, device=x.device, dtype=torch.float32)
    _cuda.check(lib.uav_resblock_conv(xf.data_ptr(), a1.data_ptr(), d1.data_ptr(),
                                      w1t.data_ptr(), w1t.shape[0], b1t.data_ptr(),
                                      _cuda.ptr(temb), None, h1.data_ptr(), part2.data_ptr(),
                                      b, t, hw, c, tm, stream), "resblock conv1")
    a2, d2 = _gn_on_card(lib, part2, n2_w, n2_b, g2, rows * (c // g2), eps, stream)
    out = torch.empty_like(xf)
    _cuda.check(lib.uav_resblock_conv(h1.data_ptr(), a2.data_ptr(), d2.data_ptr(),
                                      w2t.data_ptr(), w2t.shape[0], b2t.data_ptr(), None,
                                      xf.data_ptr(), out.data_ptr(), None, b, t, hw, c, tm,
                                      stream), "resblock conv2")
    _cuda.count("fused_temporal_resblock", (b, t, hh, ww, c, w1.shape[2]))
    return out
