"""LLaVA checkpoint directory → :class:`LlavaCaptioner` (mirror of
``upscale_a_video_tpu/models/llava/loader.py``): ``config.json`` chooses the
decoder, the sharded ``pytorch_model*.bin`` (or ``*.safetensors``) state
dicts load into the modules as they are (the HF key names), optionally as a
delta over a base checkpoint, optionally stored in int8.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch

from ...config import resolve_device
from .clip_vision import CLIPVisionConfig
from .convert import apply_delta
from .llama import LlamaConfig
from .llava import LlavaCaptioner, LlavaConfig, LlavaModel
from .mpt import MPTConfig


def load_sharded_state(model_dir: Path) -> Dict[str, torch.Tensor]:
    """Every ``pytorch_model*.bin`` (``torch.load(weights_only=True)``), or
    else every ``*.safetensors``, of ``model_dir``, merged, on the host."""
    state: Dict[str, torch.Tensor] = {}
    bins = sorted(model_dir.glob("pytorch_model*.bin"))
    if bins:
        for b in bins:
            state.update(torch.load(str(b), map_location="cpu", weights_only=True))
        return state
    safes = sorted(model_dir.glob("*.safetensors"))
    if safes:
        from safetensors.torch import load_file

        for s in safes:
            state.update(load_file(str(s)))
        return state
    raise FileNotFoundError(f"no weights in {model_dir}")


def llava_config(hf_cfg: dict) -> LlavaConfig:
    """The model of a checkpoint's ``config.json``: MPT for a ``*mpt*``
    model type or MPT-shaped fields (JAX ``:68-77``), else LLaMA; the vision
    tower from ``vision_config`` when present."""
    vis = hf_cfg.get("vision_config") or {}
    vision = CLIPVisionConfig.from_dict(vis) if vis else CLIPVisionConfig()
    if ("mpt" in hf_cfg.get("model_type", "") or "attn_config" in hf_cfg
            or "d_model" in hf_cfg):
        return LlavaConfig(vision=vision, text_mpt=MPTConfig.from_dict(hf_cfg))
    return LlavaConfig(vision=vision, text=LlamaConfig.from_dict(hf_cfg))


def load_llava_captioner(model_dir: str, base_dir: Optional[str] = None,
                         dtype: torch.dtype = torch.bfloat16, max_new_tokens: int = 64,
                         load_8bit: bool = False, device=None) -> LlavaCaptioner:
    """A captioner from an HF checkpoint directory, on ``device`` (``cuda``
    unless the caller passes the CPU). ``base_dir`` takes the checkpoint as a
    delta over a base; ``load_8bit`` stores the large matmul weights in int8
    (``utils/quant.py``). A parameter the checkpoint lacks raises a
    ``KeyError`` (the JAX loader keeps it at its zero init and reports it,
    so a checkpoint whose names drift there loads a zeroed tower or decoder
    and captions garbage)."""
    dev = resolve_device(device)
    root = Path(model_dir)
    with open(root / "config.json") as f:
        cfg = llava_config(json.load(f))
    with torch.device("meta"):
        model = LlavaModel(cfg)
    state = load_sharded_state(root)
    if base_dir is not None:
        state = apply_delta(load_sharded_state(Path(base_dir)), state)
    missing = sorted(set(model.state_dict()) - set(state))
    if missing:
        raise KeyError(f"{root}: {len(missing)} parameters missing from the checkpoint "
                       f"(e.g. {missing[:3]})")
    model = model.to(dtype).to_empty(device=dev)
    model.load_state_dict(state, strict=False)  # extra keys (e.g. position_ids) are ignored
    model.eval()

    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(str(root), use_fast=False,
                                                  local_files_only=True)
    except Exception:  # noqa: BLE001  no tokenizer: captions need one (JAX :101-106)
        tokenizer = None

    if load_8bit:
        from ...utils.quant import module_nbytes, quantize_module_

        full = module_nbytes(model)
        quantize_module_(model)
        print(f"llava: int8 weight-only quantization {full / 1e9:.2f} GB → "
              f"{module_nbytes(model) / 1e9:.2f} GB")
    return LlavaCaptioner(model, tokenizer=tokenizer, max_new_tokens=max_new_tokens)
