"""Parameter and FLOP accounting (port of ``upscale_a_video_tpu/utils/flops.py``;
ref models_video/utils.py:192-215, the thop hooks).

- :func:`count_params`: the scalars of a module's parameters or of a state
  dict (ref ``count_params``);
- :func:`attention_flops`: the reference hook's analytic attention count;
- :func:`cost_analysis` and :func:`flops_of`: the FLOPs of one call as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them (the products:
  matrix products, convolutions, attention; 2 per multiply-add), where the
  JAX package asks XLA's cost model.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


def count_params(params) -> int:
    """Total number of scalars in a module's parameters, or in a (nested)
    state dict of tensors or arrays."""
    if isinstance(params, torch.nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    if isinstance(params, Mapping):
        return int(sum(count_params(v) for v in params.values()))
    if isinstance(params, (list, tuple)):
        return int(sum(count_params(v) for v in params))
    return int(np.prod(params.shape)) if hasattr(params, "shape") else 1


def attention_flops(batch: int, seq: int, channels: int,
                    heads: Optional[int] = None) -> int:
    """Multiply-adds of one (softmax) attention, 2 · B · S² · C, the
    reference hook's model (ref models_video/utils.py:192-211): Q·Kᵀ and
    attn·V each cost B·S²·C; the head count does not change the total and
    softmax and scales are left out. ``FlopCounterMode`` counts twice this
    (2 FLOPs per multiply-add)."""
    del heads
    return 2 * batch * seq * seq * channels


def cost_analysis(fn: Callable, *args: Any, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run once under ``FlopCounterMode``:
    ``{"flops": total, "by_operator": {operator: flops}}``."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    by_op = {str(op): float(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "by_operator": by_op}


def flops_of(fn: Callable, *args, **kwargs) -> Optional[float]:
    """Total FLOPs of ``fn(*args)`` as :func:`cost_analysis` counts them;
    None where it counts none."""
    return cost_analysis(fn, *args, **kwargs)["flops"] or None


def format_count(n: float) -> str:
    """Human-readable count (1.23 G, 45.6 M, ...)."""
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n:.0f}"
