"""Flash attention (no bias, head_dim up to 512) on the card.

Replaces ``upscale_a_video_tpu/ops/flash_attention.py::flash_attention``
(Pallas ``_flash_kernel``); the CUDA kernel is ``csrc/flash_attention.cu``.
Its plain version is :func:`ops.attention.attention_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .attention import attention_plain

BLOCK_K = 64


def flash_attention_fits(q: torch.Tensor, k: torch.Tensor, bias=None) -> bool:
    """Port gate: no bias, bf16, head_dim a multiple of 16 up to 512, and
    both sequences long enough (>= 512) that tiling beats one softmax."""
    d = q.shape[-1]
    return (bias is None and q.dtype == torch.bfloat16 and d % 16 == 0 and d <= 512
            and q.shape[-2] >= 512 and k.shape[-2] >= 512)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (..., Sq, D), k/v: (..., Sk, D) → (..., Sq, D) in q.dtype."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    *batch, sq, d = q.shape
    sk = k.shape[-2]
    qf = _cuda.operand(q.reshape(-1, sq, d), torch.bfloat16, "q")
    kf = k.reshape(-1, sk, d)
    vf = v.reshape(-1, sk, d)
    skp = -(-sk // BLOCK_K) * BLOCK_K
    if skp != sk:  # the kernel reads whole 64-key tiles; pad rows are masked
        kf = F.pad(kf, (0, 0, 0, skp - sk))
        vf = F.pad(vf, (0, 0, 0, skp - sk))
    kf = _cuda.operand(kf, torch.bfloat16, "k")
    vf = _cuda.operand(vf, torch.bfloat16, "v")
    out = torch.empty_like(qf)
    rc = _cuda.lib().uav_flash_attention(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), qf.shape[0], sq, sk, skp,
        d, float(scale), _cuda.stream_ptr(q.device))
    _cuda.check(rc, "flash_attention")
    _cuda.count("flash_attention", (*batch, sq, sk, d))
    return out.reshape(*batch, sq, d)
