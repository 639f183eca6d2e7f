"""The pipeline from a released weight bundle.

Mirror of ``upscale_a_video_tpu/pipeline/loader.py`` (``load_pipeline`` at
``:147``) for the bundle layout of the reference's README:

    <model_dir>/
      scheduler/scheduler_config.json
      low_res_scheduler/scheduler_config.json
      text_encoder/{config.json, pytorch_model.bin}
      tokenizer/{vocab.json, merges.txt}
      unet/{unet_video_config.json, unet_video.bin}
      vae/{vae_3d_config.json, vae_3d.bin, vae_video_config.json, vae_video.bin}
      propagator/raft-things.pth

The torch ``.bin`` files are the port's own state dicts (the modules carry
the reference's key names): read with ``torch.load(weights_only=True)`` and
loaded with ``strict=True``, no conversion and no cache. Configs come from
the bundle's JSONs, else from the defaults in ``config.py`` (the released
configs). ``random_init=True`` builds the same modules with PyTorch's
initialisers drawn from a generator seeded with ``seed``.
"""

from __future__ import annotations

import json
import logging
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import VIDEO_VAE, UNetVideoConfig, VaeConfig, config_from_dict, resolve_device
from ..models import AutoencoderKLVideo, CLIPTextConfig, CLIPTextModel, UNetVideoModel
from ..models.raft import load_raft
from ..sampling import DDIMScheduler, DDIMSchedulerConfig, DDPMScheduler, DDPMSchedulerConfig
from ..utils.clip_bpe import load_clip_tokenizer
from .pipeline import PipelineModules, VideoUpscalePipeline, build_module

# the stable-diffusion-x4-upscaler bundle's schedulers (SD2 betas for the
# sampler, wider ones for the LR noising); a bundle's own JSON overrides
DDIM_DEFAULTS = {"beta_schedule": "scaled_linear", "beta_start": 0.00085, "beta_end": 0.012,
                 "num_train_timesteps": 1000, "clip_sample": False,
                 "prediction_type": "epsilon", "steps_offset": 1, "set_alpha_to_one": False}
DDPM_DEFAULTS = {"beta_schedule": "scaled_linear", "beta_start": 0.0001, "beta_end": 0.02,
                 "num_train_timesteps": 1000}


class FallbackTokenizer:
    """Deterministic stand-in for runs WITHOUT tokenizer assets: byte-hash
    ids, NOT CLIP BPE tokens, so the conditioning built from them is
    meaningless. :func:`load_pipeline` builds it only when allowed."""

    def __init__(self, vocab_size: int = 49408):
        # ids must lie inside the text model's vocabulary (tiny configs shrink it)
        self.vocab_size = vocab_size
        warnings.warn("FallbackTokenizer in use: tokenizer assets are missing, prompt "
                      "conditioning will be MEANINGLESS. Provide a tokenizer dir "
                      "(vocab.json+merges.txt) for real runs.", RuntimeWarning, stacklevel=2)

    def __call__(self, prompts):
        logging.getLogger(__name__).warning(
            "FallbackTokenizer encoding %d prompt(s) with byte-hash ids — NOT real CLIP tokens",
            len(prompts))
        v = self.vocab_size
        ids = np.full((len(prompts), 77), min(49407, v - 1), dtype=np.int32)
        ids[:, 0] = min(49406, v - 2)
        for i, p in enumerate(prompts):
            for j, ch in enumerate(p.encode()[:60]):
                ids[i, 1 + j] = ch % min(49000, v - 2)
        return ids


def _resolve_tokenizer(tokenizer_dir: Optional[Path], allow_fallback: bool, vocab_size: int):
    """The in-repo CLIP BPE from the bundle's ``tokenizer/`` assets, else the
    fallback where allowed, else an error."""
    if tokenizer_dir is not None and tokenizer_dir.is_dir():
        try:
            return load_clip_tokenizer(str(tokenizer_dir))
        except FileNotFoundError:
            pass
    if allow_fallback:
        return FallbackTokenizer(vocab_size)
    raise FileNotFoundError(
        "no CLIP tokenizer assets found: provide <model_dir>/tokenizer/ with "
        "vocab.json+merges.txt (released bundle layout) or pass "
        "allow_fallback_tokenizer=True for shape-only runs")


def _json(path: Optional[Path], default: dict) -> dict:
    return json.loads(path.read_text()) if path is not None and path.exists() else default


def _torch_state(path: Path) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def _text_state(path: Path) -> Dict[str, torch.Tensor]:
    """HF CLIPTextModel keys without their ``text_model.`` prefix; the
    ``position_ids`` buffer older checkpoints save is no parameter."""
    sd = _torch_state(path)
    return {k[len("text_model."):] if k.startswith("text_model.") else k: v
            for k, v in sd.items() if not k.endswith("position_ids")}


def load_pipeline(model_dir: Optional[str] = None, use_video_vae: bool = False,
                  dtype: torch.dtype = torch.bfloat16, decode_dtype: torch.dtype = torch.float32,
                  random_init: bool = False, seed: int = 0,
                  allow_fallback_tokenizer: Optional[bool] = None,
                  device=None) -> VideoUpscalePipeline:
    """The pipeline on ``device`` (``cuda`` unless the caller names the CPU):
    UNet and CLIP in ``dtype``, the VAE (the video VAE with
    ``use_video_vae``) in ``decode_dtype``; RAFT (``raft-things.pth``) when
    the bundle has it. A bundle without ``text_encoder/pytorch_model.bin``
    keeps a randomly initialised text encoder, as the JAX loader does. The
    fallback tokenizer is allowed by default only with ``random_init``."""
    if allow_fallback_tokenizer is None:
        allow_fallback_tokenizer = random_init
    if model_dir is None and not random_init:
        raise ValueError("model_dir is required unless random_init=True")
    root = Path(model_dir) if model_dir else None
    sub = (lambda rel: root / rel) if root is not None else (lambda rel: None)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    vae_name = "vae_video" if use_video_vae else "vae_3d"
    unet_cfg = config_from_dict(UNetVideoConfig, _json(sub("unet/unet_video_config.json"), {}))
    vae_default = VIDEO_VAE if use_video_vae else VaeConfig()
    vae_json = _json(sub(f"vae/{vae_name}_config.json"), None)
    vae_cfg = vae_default if vae_json is None else config_from_dict(VaeConfig, vae_json)
    text_json = _json(sub("text_encoder/config.json"), {})
    if text_json.get("hidden_act", "gelu") != "gelu":
        raise ValueError(f"text encoder activation {text_json['hidden_act']!r}: the port's "
                         "CLIP text model has the x4 upscaler's exact GELU only")
    text_cfg = config_from_dict(CLIPTextConfig, text_json)

    tokenizer = _resolve_tokenizer(sub("tokenizer"), allow_fallback_tokenizer,
                                   text_cfg.vocab_size)
    load = not random_init
    unet_sd = _torch_state(sub("unet/unet_video.bin")) if load else None
    vae_sd = _torch_state(sub(f"vae/{vae_name}.bin")) if load else None
    text_bin = sub("text_encoder/pytorch_model.bin")
    text_sd = _text_state(text_bin) if load and text_bin.exists() else None
    raft_pth = sub("propagator/raft-things.pth")
    modules = PipelineModules(
        unet=build_module(UNetVideoModel, unet_cfg, dev, dtype, gen, unet_sd),
        vae=build_module(AutoencoderKLVideo, vae_cfg, dev, decode_dtype, gen, vae_sd),
        text_encoder=build_module(CLIPTextModel, text_cfg, dev, dtype, gen, text_sd),
        tokenizer=tokenizer,
        scheduler=DDIMScheduler(config_from_dict(
            DDIMSchedulerConfig, _json(sub("scheduler/scheduler_config.json"), DDIM_DEFAULTS))),
        low_res_scheduler=DDPMScheduler(config_from_dict(
            DDPMSchedulerConfig,
            _json(sub("low_res_scheduler/scheduler_config.json"), DDPM_DEFAULTS))),
        raft=load_raft(str(raft_pth), device=dev) if load and raft_pth.exists() else None)
    return VideoUpscalePipeline(modules, device=dev)
