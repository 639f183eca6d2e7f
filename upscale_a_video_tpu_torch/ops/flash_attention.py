"""Flash attention (no bias, head_dim up to 512) on the card.

Replaces ``upscale_a_video_tpu/ops/flash_attention.py::flash_attention``
(Pallas ``_flash_kernel``), which is dtype-generic; the port has one CUDA
kernel per operand type:
- bf16: ``csrc/flash_attention.cu`` (TMA-fed ``wgmma``, the output
  accumulator in registers), built for head widths 64, 128, 256 and 512;
- fp32: ``csrc/flash_attention_f32.cu`` (every product an FFMA on the CUDA
  cores: no TF32, no rounding of p), built for head widths 256 and 512.
  The VAE's mid-block attention takes it under ``--decode_attn fp32``.
Their plain version is :func:`ops.attention.attention_plain`, which
computes in fp32 whatever the operand type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .attention import attention_plain

WIDTHS = (64, 128, 256, 512)  # head widths the bf16 kernel is built for
F32_WIDTHS = (256, 512)       # and the fp32 kernel


def kernel_width(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The kernel width a head_dim ``d`` runs at: the next of :data:`WIDTHS`
    (fp32: :data:`F32_WIDTHS`). The wrapper zero-pads q, k and v up to it,
    as the JAX wrapper pads to 128: zero columns add nothing to the scores
    and give zero outputs."""
    return next(w for w in (F32_WIDTHS if dtype == torch.float32 else WIDTHS) if w >= d)


def flash_attention_fits(q: torch.Tensor, k: torch.Tensor, bias=None) -> bool:
    """Port gate: no bias, bf16 or fp32, head_dim a multiple of 16 up to
    512, and both sequences long enough (>= 512) that tiling beats one
    softmax."""
    d = q.shape[-1]
    return (bias is None and q.dtype in (torch.bfloat16, torch.float32) and d % 16 == 0
            and d <= 512 and q.shape[-2] >= 512 and k.shape[-2] >= 512)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (..., Sq, D), k/v: (..., Sk, D) → (..., Sq, D) in q.dtype (bf16 or
    fp32, the kernel of that operand type)."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    *batch, sq, d = q.shape
    sk = k.shape[-2]
    if d % 16 or d > 512:
        raise ValueError(f"flash_attention: head_dim {d} is not a multiple of 16 up to 512")
    f32 = q.dtype == torch.float32
    dk = kernel_width(d, q.dtype)
    qf, kf, vf = (t.reshape(-1, t.shape[-2], d) for t in (q, k, v))
    if dk != d:
        qf, kf, vf = (F.pad(t, (0, dk - d)) for t in (qf, kf, vf))
    if f32:
        qf, kf, vf = (_cuda.operand(t, torch.float32, n)
                      for t, n in ((qf, "q"), (kf, "k"), (vf, "v")))
        name, entry = "flash_attention_f32", _cuda.lib().uav_flash_attention_f32
    else:
        qf, kf, vf = (_cuda.tma_operand(t, n) for t, n in ((qf, "q"), (kf, "k"), (vf, "v")))
        name, entry = "flash_attention", _cuda.lib().uav_flash_attention
    out = torch.empty_like(qf)
    rc = entry(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), qf.shape[0], sq, sk,
               dk, float(scale), _cuda.stream_ptr(q.device))
    _cuda.check(rc, name)
    _cuda.count(name, (*batch, sq, sk, d))
    if dk != d:
        out = out[..., :d]
    return out.reshape(*batch, sq, d)
