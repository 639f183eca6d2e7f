"""Learning-rate schedules (mirror of
``upscale_a_video_tpu/training/lr_schedules.py``; ref
models_video/__init__.py:4-23): linear warmup and cosine annealing as
functions of the step. Each gives the learning rate itself; for a
``torch.optim.lr_scheduler.LambdaLR`` (which multiplies the optimizer's lr)
pass ``lambda step: schedule(step) / base_lr``."""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_schedule(base_lr: float, warmup_steps: int = 5000) -> Schedule:
    """lr = base · min(step / warmup_steps, 1) (ref :6-13)."""
    if warmup_steps <= 0:
        return lambda step: base_lr
    return lambda step: base_lr * min(step / warmup_steps, 1.0)


def cosine_schedule(base_lr: float, decay_steps: int, eta_min: float = 0.0) -> Schedule:
    """CosineAnnealingLR (ref :19-21), as ``optax.cosine_decay_schedule``
    with ``alpha = eta_min / base_lr``: constant at ``eta_min`` after
    ``decay_steps``."""
    if decay_steps <= 0:
        raise ValueError(f"cosine_schedule needs positive decay_steps, got {decay_steps}")
    alpha = eta_min / base_lr if base_lr > 0 else 0.0

    def schedule(step: int) -> float:
        cos = 0.5 * (1 + math.cos(math.pi * min(step, decay_steps) / decay_steps))
        return base_lr * ((1 - alpha) * cos + alpha)

    return schedule


def get_lr_schedule(name: str, base_lr: float, **kwargs) -> Schedule:
    """ref get_lr_scheduler (:16-23)."""
    if name == "warmup":
        return warmup_schedule(base_lr, **kwargs)
    if name == "cosine":
        return cosine_schedule(base_lr, **kwargs)
    raise NotImplementedError(name)
