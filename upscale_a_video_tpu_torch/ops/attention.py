"""Scaled-dot-product attention core used by every attention module.

Mirror of ``upscale_a_video_tpu/ops/attention.py``: fp32 scores and softmax
with max subtraction whatever the operand dtype; on the card, calls with
Sq, Sk >= 512 and no bias go to the flash kernel. The reference's
``attention_packed_small`` is a TPU packing of the same maths and has no
counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (..., Sq, D), k/v: (..., Sk, D), bias broadcastable to (..., Sq, Sk)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    from .flash_attention import flash_attention, flash_attention_fits

    if _cuda.use_kernel(q) and flash_attention_fits(q, k, bias):
        return flash_attention(q, k, v, scale)
    return attention_plain(q, k, v, scale, bias)
