"""The CLI's captioner (mirror of ``upscale_a_video_tpu/captioner.py``; the
reference's LLaVA agent captions frame 0 and the caption is prepended to
``a_prompt``). Backends, in the JAX order:

1. ``UAV_CAPTION_TORCH_MODEL``: the port's LLaVA (``models/llava``) from a
   checkpoint directory, on the pipeline's device (the JAX package's
   ``UAV_CAPTION_JAX_MODEL``);
2. ``UAV_CAPTION_ENDPOINT``: an HTTP service that receives the frame as a
   PNG and answers with the caption;
3. none: the CLI runs with an empty caption.

The JAX package's third backend, a ``transformers`` image-to-text pipeline
from the hub, has no counterpart here.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from .ops.resize import resize_2d
from .utils import video_io

CAPTION_QUESTION = "Describe this image and its style in a very detailed manner."


def _resize_short_side(frame_u8: np.ndarray, target: int = 512) -> np.ndarray:
    """Bicubic resize so that min(H, W) == target (ref driver :162-168)."""
    h, w = frame_u8.shape[:2]
    scale = target / min(w, h)
    out = resize_2d(torch.as_tensor(frame_u8, dtype=torch.float32),
                    (round(h * scale), round(w * scale)), "bicubic")
    return np.clip(out.numpy(), 0, 255).astype(np.uint8)


class EndpointCaptioner:
    """POSTs the resized frame as a PNG to ``url`` with the question in the
    ``X-Question`` header; the reply body is the caption."""

    def __init__(self, url: str):
        self.url = url

    def __call__(self, frame_u8: np.ndarray) -> str:
        import urllib.request

        req = urllib.request.Request(
            self.url, data=video_io.encode_png(_resize_short_side(frame_u8)),
            headers={"Content-Type": "image/png", "X-Question": CAPTION_QUESTION})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.read().decode().strip()


def build_captioner(load_8bit: bool = False,
                    device=None) -> Optional[Callable[[np.ndarray], str]]:
    """The first configured backend, or None (as ``--no_llava``). A local
    model that fails to load is reported and the next backend tried, as the
    JAX CLI does."""
    model_dir = os.environ.get("UAV_CAPTION_TORCH_MODEL")
    if model_dir:
        try:
            from .models.llava.loader import load_llava_captioner

            cap = load_llava_captioner(model_dir, load_8bit=load_8bit, device=device)
            return lambda frame_u8: cap.caption(frame_u8)
        except Exception as e:  # noqa: BLE001  the CLI goes on with the next backend
            print(f"llava unavailable ({e!r}); trying other backends")
    endpoint = os.environ.get("UAV_CAPTION_ENDPOINT")
    if endpoint:
        return EndpointCaptioner(endpoint)
    return None
