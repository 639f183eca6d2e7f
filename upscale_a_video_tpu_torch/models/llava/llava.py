"""LLaVA captioner (mirror of ``upscale_a_video_tpu/models/llava/llava.py``):
the CLIP vision tower, the two-layer GELU projector and the LLaMA (or MPT)
decoder; the image's patch features replace the ``<image>`` placeholder in
the embedded prompt, then one prefill and host-driven decode steps over a
static KV cache, sampling with temperature and top-p (ref
llava/llava_agent.py:81-102).

The modules carry the released checkpoints' key names, so a
``pytorch_model*.bin`` loads with ``load_state_dict``: LLaVA-LLaMA is a
``LlamaForCausalLM`` whose ``model`` also holds ``vision_tower`` and
``mm_projector`` (HF ``LlavaLlamaForCausalLM``), LLaVA-MPT an
``MPTForCausalLM`` whose ``transformer`` holds them
(``LlavaMPTForCausalLM``). :func:`LlavaModel` builds the one the config
names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .clip_vision import CLIPVisionConfig, CLIPVisionTower
from .llama import LlamaConfig, LlamaForCausalLM, causal_prefill_mask, decode_step_mask
from .mpt import MPTConfig, MPTForCausalLM


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    vision: CLIPVisionConfig = CLIPVisionConfig()
    text: LlamaConfig = LlamaConfig()
    text_mpt: Optional[MPTConfig] = None  # set: the MPT decoder instead of LLaMA
    projector_hidden: Optional[int] = None  # default: the decoder's width

    @property
    def lm_hidden(self) -> int:
        return self.text_mpt.d_model if self.text_mpt else self.text.hidden_size

    @property
    def lm_dims(self) -> Tuple[int, int, int]:
        """(layers, kv heads, head dim) of the KV cache."""
        if self.text_mpt:
            c = self.text_mpt
            return c.n_layers, (1 if c.multiquery else c.n_heads), c.head_dim
        c = self.text
        return c.num_hidden_layers, c.kv_heads, c.hidden_size // c.num_attention_heads


class _Llava:
    """The multimodal methods over a causal LM whose decoder body
    (:attr:`body`) also holds the vision tower and the projector."""

    def _attach(self, config: LlavaConfig, body: nn.Module) -> None:
        self.llava_config = config
        clip = nn.Module()  # HF CLIPVisionTower → CLIPVisionModel → vision_model
        clip.vision_tower = nn.Module()
        clip.vision_tower.vision_model = CLIPVisionTower(config.vision)
        body.vision_tower = clip
        hidden = config.projector_hidden or config.lm_hidden
        body.mm_projector = nn.Sequential(nn.Linear(config.vision.hidden_size, hidden),
                                          nn.GELU(), nn.Linear(hidden, config.lm_hidden))

    @property
    def vision(self) -> CLIPVisionTower:
        return self.body.vision_tower.vision_tower.vision_model

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, patches, decoder width) projected features."""
        return self.body.mm_projector(self.vision(pixels))

    def splice(self, input_ids: torch.Tensor, image_embeds: torch.Tensor,
               image_pos: int) -> torch.Tensor:
        """Embedded tokens (B, S) with the placeholder at ``image_pos``
        replaced by the P patch embeddings: (B, S - 1 + P, C)."""
        emb = self.embed(input_ids)
        return torch.cat([emb[:, :image_pos], image_embeds.to(emb.dtype),
                          emb[:, image_pos + 1:]], dim=1)

    def prefill(self, inputs_embeds: torch.Tensor, max_len: int):
        """The whole prompt into a fresh cache: (last logits, kv cache)."""
        n_layers, kv_heads, d = self.llava_config.lm_dims
        b, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        kv = torch.zeros((n_layers, 2, b, kv_heads, max_len, d), dtype=inputs_embeds.dtype,
                         device=dev)
        logits, kv = self(inputs_embeds, torch.arange(s, device=dev), kv, 0,
                          causal_prefill_mask(s, max_len, dev))
        return logits[:, -1], kv

    def decode_one(self, token: torch.Tensor, kv_caches: torch.Tensor, index: int):
        """One step at position ``index``; token (B,). The cache is written
        in place."""
        dev = token.device
        logits, kv = self(self.embed(token[:, None]), torch.full((1,), index, device=dev),
                          kv_caches, index, decode_step_mask(index, kv_caches.shape[-2], dev))
        return logits[:, -1], kv


class LlavaLlamaForCausalLM(_Llava, LlamaForCausalLM):
    def __init__(self, config: LlavaConfig):
        super().__init__(config.text)
        self._attach(config, self.model)

    @property
    def body(self):
        return self.model


class LlavaMPTForCausalLM(_Llava, MPTForCausalLM):
    def __init__(self, config: LlavaConfig):
        super().__init__(config.text_mpt)
        self._attach(config, self.transformer)

    @property
    def body(self):
        return self.transformer


def LlavaModel(config: LlavaConfig = LlavaConfig()) -> nn.Module:  # noqa: N802 (JAX's name)
    """The LLaVA model of ``config``: MPT when ``text_mpt`` is set, else LLaMA."""
    if config.text_mpt is not None:
        return LlavaMPTForCausalLM(config)
    return LlavaLlamaForCausalLM(config)


def top_p_filter(logits: torch.Tensor, temperature: float = 0.2,
                 top_p: float = 0.7) -> torch.Tensor:
    """The nucleus distribution of JAX ``sample_top_p`` (``:117-128``):
    softmax(logits / T), the most likely tokens kept until their mass
    reaches ``top_p`` (the first always), renormalised; (B, V) fp32 in
    vocabulary order, zero outside the nucleus."""
    probs = torch.softmax(logits.float() / max(temperature, 1e-5), dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = sorted_probs.cumsum(dim=-1)
    kept = torch.where(cum - sorted_probs < top_p, sorted_probs, 0.0)
    kept = kept / kept.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter_(-1, order, kept)


def sample_top_p(logits, temperature: float, top_p: float,
                 generator: torch.Generator) -> torch.Tensor:
    """One token (B,) drawn from :func:`top_p_filter` with ``generator``
    (JAX's threefry draw cannot be reproduced; its support is the same)."""
    return torch.multinomial(top_p_filter(logits, temperature, top_p), 1,
                             generator=generator)[:, 0]


class LlavaCaptioner:
    """Caption generation around a :func:`LlavaModel` on its device."""

    def __init__(self, model: nn.Module, tokenizer=None, max_new_tokens: int = 64,
                 temperature: float = 0.2, top_p: float = 0.7, eos_token_id: int = 2):
        self.model = model
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.eos_token_id = eos_token_id

    @torch.no_grad()
    def generate_tokens(self, input_ids: np.ndarray, pixels: np.ndarray, image_pos: int,
                        seed: int = 0) -> np.ndarray:
        """(B, max_new_tokens) token ids: the prompt ``input_ids`` (B, S) with
        the image ``pixels`` (B, H, W, 3) at ``image_pos``, then sampled (or
        greedy at temperature 0) tokens; after EOS a row repeats EOS, as JAX
        does. The steps are issued from the host and never wait for the card
        (no early stop, as JAX's scan)."""
        m = self.model
        dev = next(m.parameters()).device
        ids = torch.as_tensor(np.asarray(input_ids), device=dev)
        img = m.encode_image(torch.as_tensor(np.asarray(pixels), device=dev))
        emb = m.splice(ids, img, image_pos)
        total = emb.shape[1]
        logits, kv = m.prefill(emb, total + self.max_new_tokens)
        gen = torch.Generator(device=dev).manual_seed(seed)
        done = torch.zeros(ids.shape[0], dtype=torch.bool, device=dev)
        eos = torch.full_like(done, self.eos_token_id, dtype=torch.long)
        tokens = []
        for step in range(self.max_new_tokens):
            if self.temperature > 0:
                token = sample_top_p(logits, self.temperature, self.top_p, gen)
            else:
                token = logits.argmax(dim=-1)
            token = torch.where(done, eos, token)
            done = done | (token == self.eos_token_id)
            tokens.append(token)
            if step + 1 < self.max_new_tokens:
                logits, kv = m.decode_one(token, kv, total + step)
        return torch.stack(tokens, dim=1).cpu().numpy()

    def caption(self, image_u8: np.ndarray, seed: int = 0,
                stop_strings: tuple = ("</s>",)) -> str:
        """Preprocess, template, generate, decode; the text is cut at EOS and
        at the first stop string (ref KeywordsStoppingCriteria)."""
        from .conversation import build_caption_prompt, preprocess_image

        if self.tokenizer is None:
            raise ValueError("caption() needs a tokenizer")
        pixels = preprocess_image(image_u8, self.model.llava_config.vision.image_size)
        ids, image_pos = build_caption_prompt(self.tokenizer)
        tokens = self.generate_tokens(ids[None], pixels[None], image_pos, seed)
        toks = []
        for t in tokens[0]:
            if int(t) == self.eos_token_id:
                break
            toks.append(int(t))
        text = self.tokenizer.decode(toks, skip_special_tokens=True)
        for kw in stop_strings:
            if kw in text:
                text = text.split(kw)[0]
        return text.strip()
