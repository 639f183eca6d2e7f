"""Conversation template and image preprocessing of the captioner (mirror
of ``upscale_a_video_tpu/models/llava/conversation.py``; ref
llava/conversation.py vicuna_v1, llava/llava_agent.py:34 question,
llava/mm_utils.py tokenizer_image_token). The vicuna_v1 prompt is
``<system> USER: <image>\\n<question> ASSISTANT:`` with the ``<image>``
placeholder spliced at the embedding level.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...ops.resize import resize_2d

SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)
QUESTION = "Describe this image and its style in a very detailed manner."
IMAGE_TOKEN_INDEX = -200  # ref llava/constants.py

# CLIP normalisation (OpenAI statistics)
_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_image(image_u8: np.ndarray, size: int = 336) -> np.ndarray:
    """uint8 (H, W, 3) → normalised float32 (size, size, 3): shortest-edge
    bicubic resize, centre crop, CLIP normalisation (CLIPImageProcessor)."""
    h, w = image_u8.shape[:2]
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    img = resize_2d(torch.as_tensor(image_u8, dtype=torch.float32) / 255.0, (nh, nw),
                    "bicubic").numpy()
    top, left = (nh - size) // 2, (nw - size) // 2
    img = img[top: top + size, left: left + size]
    return ((np.clip(img, 0, 1) - _MEAN) / _STD).astype(np.float32)


def build_caption_prompt(tokenizer) -> Tuple[np.ndarray, int]:
    """The tokenised vicuna_v1 caption prompt: (ids (S,), image_pos), where
    ids[image_pos] is a placeholder the model replaces by the patch
    features."""
    pre_ids = tokenizer(f"{SYSTEM} USER: ", add_special_tokens=True)["input_ids"]
    post_ids = tokenizer(f"\n{QUESTION} ASSISTANT:", add_special_tokens=False)["input_ids"]
    ids = np.asarray(pre_ids + [0] + post_ids, dtype=np.int32)  # 0: the placeholder
    return ids, len(pre_ids)
