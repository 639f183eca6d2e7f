"""Int8 weight-only quantization for ``--load_8bit_llava`` (mirror of
``upscale_a_video_tpu/utils/quant.py``; ref llava/model/builder.py:29-38,
bitsandbytes): per-output-channel symmetric int8 values and fp32 scales,
``values * scale`` ≈ the weight. Activations stay in the model's dtype.

A :class:`QuantizedLinear` keeps the int8 weight and its scales as buffers
and dequantizes in ``forward`` before ``F.linear``: every call reads the int8
weight and writes a bf16 copy (the JAX package lets XLA fuse the dequantize
into the product's operand read; a fused int8 GEMM is later work). The
scope is JAX's ``_default_should_quantize``: 2-D or more, at least 16,384
values, and no embedding, norm, position, relative-bias or logit table in
the name.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_SKIP = ("embed", "norm", "position", "relative_attention_bias", "logit")


def quantize(w: torch.Tensor, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per index of ``axis`` (the output
    features: 0 for a torch Linear weight); every other axis is reduced.
    Returns (int8 values, fp32 scales of the same rank)."""
    w = w.float()
    axis = axis % w.ndim
    dims = tuple(a for a in range(w.ndim) if a != axis)
    scale = w.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize(values: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return values.to(dtype) * scale.to(dtype)


class QuantizedLinear(nn.Module):
    """A Linear whose weight is stored as int8 values and per-row fp32
    scales (buffers ``weight`` and ``scale``); the bias stays as it was."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        q, scale = quantize(linear.weight.detach())
        self.register_buffer("weight", q)
        self.register_buffer("scale", scale)
        self.bias = linear.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = dequantize(self.weight, self.scale, x.dtype)
        return F.linear(x, w, None if self.bias is None else self.bias.to(x.dtype))


def default_should_quantize(name: str, weight: torch.Tensor) -> bool:
    """JAX's ``_default_should_quantize`` (``:93-103``) on a Linear's
    qualified name and weight."""
    if weight.ndim < 2 or weight.numel() < 16384:
        return False
    return not any(s in name.lower() for s in _SKIP)


def quantize_module_(model: nn.Module,
                     should_quantize: Optional[Callable[[str, torch.Tensor], bool]] = None
                     ) -> nn.Module:
    """Replace, in place, every ``nn.Linear`` that ``should_quantize(name,
    weight)`` selects (:func:`default_should_quantize`) by a
    :class:`QuantizedLinear` on the same device. Returns ``model``."""
    pred = should_quantize or default_should_quantize
    for name, mod in list(model.named_modules()):
        if isinstance(mod, nn.Linear) and pred(f"{name}.weight", mod.weight):
            parent_name, _, child = name.rpartition(".")
            parent = model.get_submodule(parent_name) if parent_name else model
            setattr(parent, child, QuantizedLinear(mod))
    return model


def module_nbytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer (int8 values and scales count as
    stored)."""
    return sum(t.numel() * t.element_size() for t in (*model.parameters(), *model.buffers()))
