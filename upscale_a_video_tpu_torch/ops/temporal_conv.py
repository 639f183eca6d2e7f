"""SAME-T (k,1,1) temporal convolution with bias on channels-last
(B, T, H, W, C) video, as k frame-shifted GEMMs.

Replaces ``upscale_a_video_tpu/ops/temporal_conv.py::temporal_conv`` (Pallas
``_kernel``; oracle ``_conv_reference``); the CUDA kernel is
``csrc/temporal_conv.cu``, the GEMM core of ``csrc/gemm_core.cuh`` (an
implicit GEMM on TMA-fed ``wgmma`` tiles) with a bias epilogue; the temporal
resblock runs the same core. As in the JAX package it is wired into no
model: ``nn.blocks.TemporalConv`` stays on PyTorch's own conv. The port keeps
torch's Conv3d weight layout (Cout, Cin, k, 1, 1); the JAX function takes
DHWIO (k, 1, 1, Cin, Cout).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

def tap_major(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (Co, Ci, k, 1, 1) → (k, Co, Ci), contiguous: the
    kernels' B operand, one (Co, Ci) matrix per tap."""
    return weight[..., 0, 0].permute(2, 0, 1).contiguous()


def taps_operand(weight: torch.Tensor, name: str = "weight") -> torch.Tensor:
    """:func:`tap_major` in bf16 on the card, made once per version of the
    weight (``_cuda.cached``)."""
    return _cuda.cached(weight, "taps", lambda w: _cuda.tma_operand(
        tap_major(w.to(torch.bfloat16)), name))


def temporal_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, H, W, Ci) × torch Conv3d weight (Co, Ci, k, 1, 1) → (B, T, H, W, Co)."""
    k = weight.shape[2]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), padding=((k - 1) // 2, 0, 0))
    return y.permute(0, 2, 3, 4, 1)


def temporal_conv_fits(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """bf16, an odd (k,1,1) kernel, Cin and Cout multiples of 16 (TMA needs
    16-byte row strides). Any T and any frame size: ragged tiles are TMA's
    zero fill on load and masked on store."""
    cin = x.shape[-1]
    cout, wcin, k, kh, kw = weight.shape
    return (x.dtype == torch.bfloat16 and x.dim() == 5 and wcin == cin and (kh, kw) == (1, 1)
            and k % 2 == 1 and cin % 16 == 0 and cout % 16 == 0)


def temporal_conv(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, T, H, W, Cin); weight: (Cout, Cin, k, 1, 1); bias: (Cout,) or
    None. Returns (B, T, H, W, Cout) in x.dtype."""
    if not x.is_cuda:
        return temporal_conv_plain(x, weight, bias)
    if not temporal_conv_fits(x, weight):
        raise ValueError(f"temporal_conv: unsupported x {tuple(x.shape)} {x.dtype}, "
                         f"weight {tuple(weight.shape)}")
    b, t, h, w, cin = x.shape
    cout, k = weight.shape[0], weight.shape[2]
    xf = _cuda.tma_operand(x, "x")
    taps = taps_operand(weight)
    bf = None if bias is None else _cuda.weight(bias, torch.bfloat16, "bias")
    out = torch.empty(b, t, h, w, cout, device=x.device, dtype=torch.bfloat16)
    rc = _cuda.lib().uav_temporal_conv_bias(
        xf.data_ptr(), taps.data_ptr(), k, _cuda.ptr(bf), out.data_ptr(), b, t, h * w, cin, cout,
        _cuda.stream_ptr(x.device))
    _cuda.check(rc, "temporal_conv")
    _cuda.count("temporal_conv", (b, t, h, w, cin, k))
    return out
