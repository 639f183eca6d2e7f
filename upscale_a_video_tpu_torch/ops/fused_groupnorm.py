"""Channels-last GroupNorm with an optional SiLU: statistics per (sample,
group) over every non-channel axis (torch's 4-D/5-D GroupNorm), fp32
statistics, result in the input dtype (bf16 or fp32).

Replaces ``upscale_a_video_tpu/ops/fused_groupnorm.py::fused_group_norm``
(Pallas ``_stats_kernel`` and ``_apply_kernel``; oracle ``_gn_reference``);
the CUDA kernels are ``csrc/fused_groupnorm.cu``. As in the JAX package, its
only user is :class:`nn.blocks.FusedGroupNorm`, which no model uses.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

ACTS = (None, "silu")
BLOCKS = 264  # partial-sum blocks over all samples: two waves of the card's 132 SMs


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-6,
                     act: Optional[str] = "silu") -> torch.Tensor:
    """The reference's ``_gn_reference``: two-pass fp32 statistics, the
    affine and the activation in fp32, one rounding to ``x.dtype``."""
    n, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(n, -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def fused_group_norm_fits(x: torch.Tensor, num_groups: int, act: Optional[str] = "silu") -> bool:
    c = x.shape[-1]
    return (x.dtype in (torch.bfloat16, torch.float32) and x.ndim >= 2 and c % 4 == 0
            and c % num_groups == 0 and act in ACTS and x.numel() > 0)


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float = 1e-6,
                     act: Optional[str] = "silu") -> torch.Tensor:
    """x: (N, ..., C); weight, bias: (C,). GroupNorm (+ SiLU with
    ``act="silu"``) over all non-channel axes of each sample."""
    if not x.is_cuda:
        return group_norm_plain(x, weight, bias, num_groups, eps, act)
    if not fused_group_norm_fits(x, num_groups, act):
        raise ValueError(f"fused_group_norm: unsupported input {tuple(x.shape)} {x.dtype}, "
                         f"groups={num_groups}, act={act!r}")
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    xf = _cuda.operand(x, x.dtype, "x")
    w = _cuda.weight(weight, torch.float32, "weight")
    b = _cuda.weight(bias, torch.float32, "bias")
    nblk = max(1, min(rows, -(-BLOCKS // n)))
    part = torch.empty(n, nblk, c, 2, device=x.device, dtype=torch.float32)
    a = torch.empty(n, c, device=x.device, dtype=torch.float32)
    d = torch.empty_like(a)
    out = torch.empty_like(xf)
    rc = _cuda.lib().uav_fused_group_norm(
        xf.data_ptr(), w.data_ptr(), b.data_ptr(), part.data_ptr(), a.data_ptr(), d.data_ptr(),
        out.data_ptr(), n, rows, c, num_groups, nblk, float(eps),
        int(x.dtype == torch.float32), int(act == "silu"), _cuda.stream_ptr(x.device))
    _cuda.check(rc, "fused_group_norm")
    _cuda.count("fused_group_norm", (*x.shape, str(x.dtype).split(".")[-1], act))
    return out
