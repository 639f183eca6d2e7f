"""LoRA adapters on ``nn.Linear`` modules (mirror of
``upscale_a_video_tpu/training/lora.py``; ref llava/train/train.py:100-106
``lora_enable``, PEFT's LoRA).

Weight-space form, as JAX: a targeted Linear's weight W (out, in) runs as
``W + (alpha / r) · (A @ B)ᵀ`` with A (in, r) drawn N(0, stddev²) and B
(r, out) zero, so the adapted model starts exactly at the base model. The
adapter is a ``torch.nn.utils.parametrize`` parametrization of the weight
(recomputed at each use, its gradient reaching A and B only); the base
weights are frozen and left as they are. :func:`merge_lora` bakes the
adapters into the base weights for serving (ref ``merge_lora_weights.py``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

# JAX's DEFAULT_TARGETS on flax paths (".../self_attn_q_proj/kernel"), on the
# port's module names (LLaMA's q/k/v/o and gate/up/down projections, MPT's
# fused Wqkv and out_proj, the CLIP tower's out_proj, the mm_projector)
DEFAULT_TARGETS = (r".*(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj|Wqkv|"
                   r"out_proj|mm_projector.*)$")


class LoraAdapter(nn.Module):
    """The parametrization W → W + scale · (A @ B)ᵀ, scale = alpha / r."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)
        self.scale = 1.0

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return w + ((self.a @ self.b) * self.scale).t().to(w.dtype)


def lora_targets(model: nn.Module, targets: str = DEFAULT_TARGETS) -> List[Tuple[str, nn.Linear]]:
    """The Linear modules whose names match ``targets``, in module order."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, nn.Linear) and re.match(targets, name)]


def init_lora(model: nn.Module, rank: int = 8, *, targets: str = DEFAULT_TARGETS,
              generator: Optional[torch.Generator] = None,
              stddev: float = 0.01) -> Dict[str, LoraAdapter]:
    """{module name: adapter} for every targeted Linear: A (in, rank) fp32
    N(0, stddev²) from ``generator``, B (rank, out) zero, on the weight's
    device."""
    lora = {}
    for name, lin in lora_targets(model, targets):
        dev = lin.weight.device
        a = torch.randn((lin.in_features, rank), generator=generator, device=dev) * stddev
        lora[name] = LoraAdapter(a, torch.zeros((rank, lin.out_features), device=dev))
    return lora


def apply_lora(model: nn.Module, lora: Dict[str, LoraAdapter], alpha: float = 16.0) -> nn.Module:
    """Run ``model`` adapted: each adapter becomes its Linear's weight
    parametrization with scale alpha / r; every base parameter is frozen.
    The base weights themselves stay as they are (:func:`remove_lora`)."""
    for p in model.parameters():
        p.requires_grad_(False)
    modules = dict(model.named_modules())
    for name, adapter in lora.items():
        adapter.scale = alpha / adapter.a.shape[1]
        lin = modules[name]
        if parametrize.is_parametrized(lin, "weight"):
            raise ValueError(f"{name} already carries an adapter")
        parametrize.register_parametrization(lin, "weight", adapter)
    for p in lora_parameters(lora):
        p.requires_grad_(True)
    return model


def remove_lora(model: nn.Module, merge: bool = False) -> nn.Module:
    """Take the adapters off; with ``merge`` each adapted weight stays as the
    base weight (:func:`merge_lora`)."""
    for m in model.modules():
        if parametrize.is_parametrized(m, "weight"):
            parametrize.remove_parametrizations(m, "weight", leave_parametrized=merge)
    return model


@torch.no_grad()
def merge_lora(model: nn.Module, lora: Dict[str, LoraAdapter], alpha: float = 16.0) -> nn.Module:
    """Bake the adapters into the base weights (the serving-time merge):
    the same outputs as :func:`apply_lora`, with plain Linear weights."""
    return remove_lora(apply_lora(model, lora, alpha), merge=True)


def lora_parameters(lora: Dict[str, LoraAdapter]) -> Iterator[nn.Parameter]:
    for adapter in lora.values():
        yield adapter.a
        yield adapter.b


def num_lora_params(lora: Dict[str, LoraAdapter]) -> int:
    return sum(p.numel() for p in lora_parameters(lora))


def make_lora_train_step(model: nn.Module, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                         lora: Dict[str, LoraAdapter], alpha: float = 16.0) -> Callable:
    """``loss_fn(model, batch) -> scalar`` run on the adapted model; returns
    ``step(batch) -> loss`` that updates ONLY the adapters (``optimizer``
    over :func:`lora_parameters`). The adapters are applied here."""
    apply_lora(model, lora, alpha)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return step
