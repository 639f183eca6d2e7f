"""Captioner (LLaVA) finetuning (mirror of
``upscale_a_video_tpu/training/train_llava.py``; ref llava/train/train.py:756
``train``): next-token cross-entropy over the caption tokens, the prompt and
the image-patch positions masked to :data:`IGNORE_INDEX` (ref
``preprocess_v1``), optimized either in full with the vision tower frozen
(ref ``freeze_backbone``) or through LoRA adapters only (:mod:`.lora`).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..models.llava.llama import causal_prefill_mask
from .lora import LoraAdapter, make_lora_train_step

IGNORE_INDEX = -100  # ref llava/constants.py IGNORE_INDEX


def splice_labels(input_ids, image_pos: int, n_patches: int, prompt_len: int) -> np.ndarray:
    """(B, S - 1 + P) labels of the spliced sequence: IGNORE everywhere but
    the answer span (tokens at ``prompt_len`` and after, past the image),
    moved through the splice (the placeholder at ``image_pos`` becomes
    ``n_patches`` ignored positions)."""
    ids = np.asarray(input_ids)
    b, s = ids.shape
    out = np.full((b, s - 1 + n_patches), IGNORE_INDEX, np.int64)
    for j in range(s):
        if j <= image_pos or j < prompt_len:
            continue
        out[:, j - 1 + n_patches] = ids[:, j]
    return out


def caption_logits(model, pixels: torch.Tensor, input_ids: torch.Tensor,
                   image_pos: int) -> torch.Tensor:
    """Teacher-forced logits (B, S - 1 + P, V) of the spliced sequence: one
    causal pass, no cache."""
    emb = model.splice(input_ids, model.encode_image(pixels), image_pos)
    s, dev = emb.shape[1], emb.device
    logits, _ = model(emb, torch.arange(s, device=dev), None, 0, causal_prefill_mask(s, s, dev))
    return logits


def caption_loss_fn(model, image_pos: int) -> Callable:
    """``loss(model, batch)``, batch = {"pixels" (B, H, W, 3), "input_ids"
    (B, S), "labels" (B, S - 1 + P)}: the mean cross-entropy of the logits at
    t against the labels at t + 1 over the positions not ignored."""

    def loss(mdl, batch):
        logits = caption_logits(mdl, batch["pixels"], batch["input_ids"], image_pos)
        logits = logits[:, :-1].float()
        labels = batch["labels"][:, 1:].long()
        valid = labels != IGNORE_INDEX
        ce = F.cross_entropy(logits.transpose(1, 2), torch.where(valid, labels, 0),
                             reduction="none")
        return (ce * valid).sum() / valid.sum().clamp(min=1)

    return loss


def vision_frozen_mask(model) -> Dict[str, str]:
    """{parameter name: "train" or "freeze"}: the vision tower frozen
    (ref ``freeze_backbone``-style selective tuning), the rest trained."""
    return {name: "freeze" if "vision_tower" in name.split(".") else "train"
            for name, _ in model.named_parameters()}


def frozen_vision_optimizer(model, inner: Callable) -> torch.optim.Optimizer:
    """``inner(params)`` over the parameters that :func:`vision_frozen_mask`
    trains; the vision tower gets ``requires_grad=False`` and no state."""
    labels = vision_frozen_mask(model)
    trained = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if labels[name] == "train":
            trained.append(p)
    return inner(trained)


def make_caption_train_step(model, optimizer: torch.optim.Optimizer, image_pos: int) -> Callable:
    """Full-parameter step (vision frozen by :func:`frozen_vision_optimizer`):
    ``step(batch) -> loss``."""
    loss_fn = caption_loss_fn(model, image_pos)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return step


def make_caption_lora_step(model, optimizer: torch.optim.Optimizer, image_pos: int,
                           lora: Dict[str, LoraAdapter], alpha: float = 16.0) -> Callable:
    """LoRA-adapter-only step (ref train.py:100-106 ``lora_enable``):
    ``step(batch) -> loss``; ``optimizer`` over the adapters'
    parameters."""
    return make_lora_train_step(model, caption_loss_fn(model, image_pos), optimizer, lora, alpha)
