"""Channels-last GroupNorm with an optional SiLU: statistics per (sample,
group) over every non-channel axis (torch's 4-D/5-D GroupNorm), fp32
statistics, result in the input dtype (bf16 or fp32).

Replaces ``upscale_a_video_tpu/ops/fused_groupnorm.py::fused_group_norm``
(Pallas ``_stats_kernel`` and ``_apply_kernel``; oracle ``_gn_reference``);
the CUDA kernels are ``csrc/fused_groupnorm.cu`` and ``csrc/group_norm.cuh``.
As in the JAX package, its only user is :class:`nn.blocks.FusedGroupNorm`,
which no model uses; its statistics pass (with the finalize in each sample's
last block) also serves the temporal resblock's first GroupNorm.

The host plans the statistics pass's blocks (:func:`stats_plan`); beside the
kernels, :func:`block_sums` and :func:`affine_from_block_sums` are their
reductions in plain PyTorch: per-(sample, group, block) sums, then the last
block's fixed order over the blocks (:func:`lane_order_sum` on
:func:`finalize_lanes` lanes).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

ACTS = (None, "silu")
THREADS = 512      # threads of a statistics or apply block (csrc/group_norm.cuh kGnThreads)
UNROLL = 4         # rows in flight per thread (kGnUnroll)
BLOCKS_PER_SM = 2  # statistics blocks over all samples, per SM of the card


def chunk_width(c: int, fp32: bool) -> int:
    """Channels a thread loads at once: 16 bytes (fp32 x 4, bf16 x 8), or
    bf16 x 4 where C % 8 != 0."""
    return 4 if fp32 or c % 8 else 8


def stats_plan(n: int, rows: int, c: int, fp32: bool, sms: int):
    """(nb, rpb): the statistics pass's blocks per sample and rows per block,
    which the apply pass takes too. A block's threads cover ``rps`` rows of
    all channels per step; about ``BLOCKS_PER_SM`` blocks per SM over the
    ``n`` samples, but no more than give each block ``UNROLL`` steps, and
    no block empty (the kernel refuses a plan that leaves one)."""
    tpr = min(c // chunk_width(c, fp32), THREADS)
    rps = THREADS // tpr
    nb = max(1, min(-(-BLOCKS_PER_SM * sms // n), -(-rows // (UNROLL * rps))))
    rpb = -(-rows // nb)
    return -(-rows // rpb), rpb


def block_sums(x: torch.Tensor, groups: int, nb: int, rpb: int) -> torch.Tensor:
    """The statistics pass's partials: x (N, ..., C) → per (sample, group,
    block of ``rpb`` rows) the sums of x and x², (N, G, nb, 2) float64."""
    n, c = x.shape[0], x.shape[-1]
    xg = x.double().reshape(n, -1, groups, c // groups)
    part = torch.zeros(n, groups, nb, 2, dtype=torch.float64, device=x.device)
    for blk in range(nb):
        rows = xg[:, blk * rpb:(blk + 1) * rpb]
        part[:, :, blk, 0] = rows.sum(dim=(1, 3))
        part[:, :, blk, 1] = (rows * rows).sum(dim=(1, 3))
    return part


def finalize_lanes(groups: int) -> int:
    """Lanes per group in the statistics pass's finalize (each sample's last
    block): 32, or fewer so that all ``groups`` fit in one round of the
    block's threads."""
    lanes = 32
    while lanes > 1 and groups * lanes > THREADS:
        lanes //= 2
    return lanes


def lane_order_sum(v: torch.Tensor, lanes: int = 32) -> torch.Tensor:
    """The kernels' fixed order over the last axis: lane l of ``lanes`` adds
    items l, l + lanes, ... in turn, then a butterfly over the lanes (every
    lane ends with the same sum)."""
    acc = torch.zeros(*v.shape[:-1], lanes, dtype=v.dtype, device=v.device)
    for i in range(0, v.shape[-1], lanes):
        chunk = v[..., i:i + lanes]
        acc[..., :chunk.shape[-1]] += chunk
    o = lanes // 2
    while o:
        acc = acc + acc[..., torch.arange(lanes, device=v.device) ^ o]
        o //= 2
    return acc[..., 0]


def fold_affine(mean, var, weight, bias, eps: float, scale: float = 1.0):
    """Per-(sample, group) mean and variance, (N, G) fp32, and the affine →
    ``scale`` · GroupNorm as y = x·a + d with a, d: (N, C) fp32."""
    n, groups = mean.shape
    c = weight.shape[0]
    rstd = torch.rsqrt(var + eps)
    w = weight.float().reshape(groups, c // groups)
    a = (rstd[:, :, None] * w).reshape(n, c)
    d = (bias.float().reshape(groups, c // groups) - (mean * rstd)[:, :, None] * w).reshape(n, c)
    return scale * a, scale * d


def affine_from_block_sums(part: torch.Tensor, count: int, weight, bias, eps: float,
                           scale: float = 1.0):
    """The statistics pass's finalize: part (N, G, nb, 2) → the affine of
    ``scale`` · GroupNorm, a, d (N, C) fp32; ``count`` elements per (sample,
    group)."""
    lanes = finalize_lanes(part.shape[1])
    s, s2 = lane_order_sum(part[..., 0], lanes), lane_order_sum(part[..., 1], lanes)
    mean = (s / count).float()
    return fold_affine(mean, (s2 / count).float() - mean * mean, weight, bias, eps, scale)


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
    ``act="silu"``) over all non-channel axes of each sample.
    Differentiable: the backward is the plain version's
    (``_cuda.differentiable``)."""
    if not x.is_cuda:
        return group_norm_plain(x, weight, bias, num_groups, eps, act)
    return _cuda.differentiable(_launch, group_norm_plain, x, weight, bias, num_groups, eps, act)


def _launch(x, weight, bias, num_groups, eps, act):
    if not fused_group_norm_fits(x, num_groups, act):
        raise ValueError(f"fused_group_norm: unsupported input {tuple(x.shape)} {x.dtype}, "
                         f"groups={num_groups}, act={act!r}")
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    xf = _cuda.operand(x, x.dtype, "x")
    w = _cuda.weight(weight, torch.float32, "weight")
    b = _cuda.weight(bias, torch.float32, "bias")
    fp32 = x.dtype == torch.float32
    nb, rpb = stats_plan(n, rows, c, fp32, _cuda.sm_count(x.device))
    part = torch.empty(n, num_groups, nb, 2, device=x.device, dtype=torch.float64)
    a = torch.empty(n, c, device=x.device, dtype=torch.float32)
    d = torch.empty_like(a)
    out = torch.empty_like(xf)
    rc = _cuda.lib().uav_fused_group_norm(
        xf.data_ptr(), w.data_ptr(), b.data_ptr(), part.data_ptr(),
        _cuda.tickets(x.device, n).data_ptr(), a.data_ptr(), d.data_ptr(), out.data_ptr(), n,
        rows, c, num_groups, nb, rpb, float(eps), int(fp32), int(act == "silu"),
        _cuda.stream_ptr(x.device))
    _cuda.check(rc, "fused_group_norm")
    _cuda.count("fused_group_norm", (*x.shape, str(x.dtype).split(".")[-1], act))
    return out
