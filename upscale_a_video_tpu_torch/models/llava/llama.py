"""LLaMA/Vicuna decoder with a static KV cache (mirror of
``upscale_a_video_tpu/models/llava/llama.py``): RMSNorm, HF half-rotation
RoPE, SwiGLU, grouped key/value heads. Key names are HF ``LlamaForCausalLM``'s
(``model.embed_tokens``, ``model.layers.N.{self_attn,mlp}.*``,
``model.norm``, ``lm_head``).

The KV cache is one tensor of (layers, 2, B, kv heads, max_len, head dim),
written in place at ``cache_index`` (JAX writes a new array each call); the
attention reads all ``max_len`` positions under an additive mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG = -1e9  # the masks' "no" (JAX's value)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 5120  # 13B
    intermediate_size: int = 13824
    num_hidden_layers: int = 40
    num_attention_heads: int = 40
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @classmethod
    def from_dict(cls, d: dict) -> "LlamaConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(S, D) fp32 cos and sin of HF's half-rotation RoPE at ``positions``
    (S,), made once per forward and shared by the layers."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=positions.device) / d))
    ang = positions.float()[:, None] * inv
    return torch.cos(ang).repeat(1, 2), torch.sin(ang).repeat(1, 2)


def rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF rotary over contiguous halves (JAX ``_rope_half``). x: (B, H, S, D)."""
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def attend(q, k, v, mask, scale: float):
    """softmax(q kᵀ · scale + mask) v with fp32 scores (JAX's
    ``preferred_element_type``), probabilities in v's dtype; k/v with fewer
    heads than q are repeated (grouped / multi-query heads)."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def write_cache(kv_cache, k, v, cache_index: int):
    """k/v (B, Hkv, S, D) into the layer's cache (2, B, Hkv, max_len, D) at
    ``cache_index``, in place; returns the cached keys and values."""
    s = k.shape[2]
    kv_cache[0, :, :, cache_index:cache_index + s] = k
    kv_cache[1, :, :, cache_index:cache_index + s] = v
    return kv_cache[0], kv_cache[1]


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        h, hkv, c = cfg.num_attention_heads, cfg.kv_heads, cfg.hidden_size
        d = c // h
        self.q_proj = nn.Linear(c, h * d, bias=False)
        self.k_proj = nn.Linear(c, hkv * d, bias=False)
        self.v_proj = nn.Linear(c, hkv * d, bias=False)
        self.o_proj = nn.Linear(h * d, c, bias=False)

    def forward(self, y, rope, kv_cache, cache_index, mask):
        cfg = self.cfg
        b, s, _ = y.shape
        h, hkv = cfg.num_attention_heads, cfg.kv_heads
        d = cfg.hidden_size // h
        split = lambda t, n: t.reshape(b, s, n, d).transpose(1, 2)
        q = rope_half(split(self.q_proj(y), h), *rope)
        k = rope_half(split(self.k_proj(y), hkv), *rope)
        v = split(self.v_proj(y), hkv)
        if kv_cache is not None:
            k, v = write_cache(kv_cache, k, v, cache_index)
        o = attend(q, k, v, mask, d ** -0.5)
        return self.o_proj(o.transpose(1, 2).reshape(b, s, h * d))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, y):
        return self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, rope, kv_cache, cache_index, mask):
        x = x + self.self_attn(self.input_layernorm(x), rope, kv_cache, cache_index, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """The decoder over input embeddings (LLaVA splices image features into
    the embedding sequence)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList([LlamaLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, x, positions, kv_caches, cache_index, mask):
        cfg = self.cfg
        rope = rope_tables(positions, cfg.hidden_size // cfg.num_attention_heads, cfg.rope_theta)
        for i, layer in enumerate(self.layers):
            x = layer(x, rope, None if kv_caches is None else kv_caches[i], cache_index, mask)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    def __init__(self, config: LlamaConfig = LlamaConfig()):
        super().__init__()
        self.config = config
        self.model = LlamaModel(config)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(input_ids.long())

    def forward(self, inputs_embeds, positions, kv_caches, cache_index: int, mask):
        """inputs_embeds (B, S, C); positions (S,); kv_caches (layers, 2, B,
        Hkv, max_len, D), written in place, or None; mask (1|B, 1, S, L)
        additive. Returns (logits, kv_caches)."""
        x = self.model(inputs_embeds, positions, kv_caches, cache_index, mask)
        return self.lm_head(x), kv_caches


def causal_prefill_mask(seq_len: int, max_len: int, device=None) -> torch.Tensor:
    """(1, 1, S, max_len) additive mask for a prefill at positions [0, S)."""
    rows = torch.arange(seq_len, device=device)[:, None]
    cols = torch.arange(max_len, device=device)[None, :]
    return torch.where(cols <= rows, 0.0, NEG)[None, None]


def decode_step_mask(cache_index: int, max_len: int, device=None) -> torch.Tensor:
    """(1, 1, 1, max_len) additive mask for one decode step at cache_index."""
    cols = torch.arange(max_len, device=device)[None, :]
    return torch.where(cols <= cache_index, 0.0, NEG)[None, None]
