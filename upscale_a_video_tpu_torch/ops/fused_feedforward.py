"""LayerNorm → GEGLU → out-projection (+ residual) on the card in three
launches: the LayerNorm, then two products on the GEMM core of
``csrc/gemm_core.cuh`` whose epilogues apply the GEGLU and the bias and
residual.

Replaces ``upscale_a_video_tpu/ops/fused_feedforward.py::fused_feedforward``
(Pallas ``_kernel``); the CUDA kernels are ``csrc/fused_feedforward.cu``.
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
    """bf16 and C a multiple of 64 up to 1024 (as the JAX gate); any number
    of rows (TMA zero-fills the last tile, whose stores are masked)."""
    c = x.shape[-1]
    return x.dtype == torch.bfloat16 and c % 64 == 0 and c <= 1024 and x.numel() > 0


def fused_feedforward(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                      add_residual: bool = False):
    """x: (..., C) pre-norm tokens → FF delta, or x + delta with ``add_residual``.
    Differentiable: the backward is the plain version's (``_cuda.differentiable``)."""
    if not x.is_cuda:
        return fused_feedforward_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, add_residual)
    return _cuda.differentiable(_launch, fused_feedforward_plain, x, ln_w, ln_b, w1, b1, w2, b2,
                                eps, add_residual)


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, eps, add_residual):
    if not feedforward_fits(x):
        raise ValueError(f"fused_feedforward: unsupported x {tuple(x.shape)} {x.dtype}")
    c = x.shape[-1]
    rows = x.numel() // c
    bf = torch.bfloat16
    xf = _cuda.tma_operand(x, "x")
    args = [_cuda.weight(t, bf, n) for t, n in
            ((ln_w, "ln_w"), (ln_b, "ln_b"), (w1, "w1"), (b1, "b1"), (w2, "w2"), (b2, "b2"))]
    if tuple(args[2].shape) != (8 * c, c) or tuple(args[4].shape) != (c, 4 * c):
        raise ValueError(f"fused_feedforward: weights {args[2].shape}, {args[4].shape} for C={c}")
    hn = torch.empty(rows, c, device=x.device, dtype=bf)
    m = torch.empty(rows, 4 * c, device=x.device, dtype=bf)
    out = torch.empty_like(xf)
    rc = _cuda.lib().uav_fused_feedforward(
        xf.data_ptr(), *[a.data_ptr() for a in args], hn.data_ptr(), m.data_ptr(),
        out.data_ptr(), rows, c, float(eps), int(add_residual), _cuda.stream_ptr(x.device))
    _cuda.check(rc, "fused_feedforward")
    _cuda.count("fused_feedforward", tuple(x.shape))
    return out
