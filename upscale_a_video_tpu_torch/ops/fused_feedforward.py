"""LayerNorm → GEGLU → out-projection (+ residual) in one kernel.

Replaces ``upscale_a_video_tpu/ops/fused_feedforward.py::fused_feedforward``
(Pallas ``_kernel``); the CUDA kernel is ``csrc/fused_feedforward.cu``.
Weights are torch Linear weights: ``w1`` (8C, C), ``w2`` (C, 4C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda


def layer_norm(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    """fp32 statistics (var = E[x²] − E[x]², as the reference), result in x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    hn = (xf - mu) * torch.rsqrt(var + eps)
    return (hn * weight.float() + bias.float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default (tanh) form, which the reference FF uses."""
    return F.gelu(x, approximate="tanh")


def fused_feedforward_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                            add_residual: bool = False):
    hn = layer_norm(x, ln_w, ln_b, eps)
    h, g = F.linear(hn, w1.to(x.dtype), b1.to(x.dtype)).chunk(2, dim=-1)
    out = F.linear(h * gelu_tanh(g), w2.to(x.dtype), b2.to(x.dtype))
    return out + x if add_residual else out


def feedforward_fits(x: torch.Tensor) -> bool:
    c = x.shape[-1]
    rows = x.numel() // c
    return (x.dtype == torch.bfloat16 and c % 128 == 0 and c <= 1024
            and rows % (32 if c <= 512 else 16) == 0)


def fused_feedforward(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                      add_residual: bool = False):
    """x: (..., C) pre-norm tokens → FF delta, or x + delta with ``add_residual``."""
    if not x.is_cuda:
        return fused_feedforward_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, add_residual)
    c = x.shape[-1]
    bf = torch.bfloat16
    xf = _cuda.operand(x, bf, "x")
    args = [_cuda.operand(t, bf, n) for t, n in
            ((ln_w, "ln_w"), (ln_b, "ln_b"), (w1, "w1"), (b1, "b1"), (w2, "w2"), (b2, "b2"))]
    if tuple(args[2].shape) != (8 * c, c) or tuple(args[4].shape) != (c, 4 * c):
        raise ValueError(f"fused_feedforward: weights {args[2].shape}, {args[4].shape} for C={c}")
    out = torch.empty_like(xf)
    rc = _cuda.lib().uav_fused_feedforward(
        xf.data_ptr(), *[a.data_ptr() for a in args], out.data_ptr(), xf.numel() // c, c,
        float(eps), int(add_residual), _cuda.stream_ptr(x.device))
    _cuda.check(rc, "fused_feedforward")
    _cuda.count("fused_feedforward", tuple(x.shape))
    return out
