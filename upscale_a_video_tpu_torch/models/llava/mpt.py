"""MPT decoder, the reference's other LLaVA language model (mirror of
``upscale_a_video_tpu/models/llava/mpt.py``): pre-norm blocks with fp32
LayerNorm statistics, one fused ``Wqkv`` with the optional ``clip_qkv``
clamp and ``qk_ln`` LayerNorms, multi-query heads, ALiBi (key-indexed, so a
left-aligned KV cache is exact) or learned positions, GELU MLP, logits from
the shared embedding. Key names are HF mosaicml MPT's
(``transformer.{wte,wpe,blocks.N.*,norm_f}``); the interface is
:class:`..llama.LlamaForCausalLM`'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .llama import attend, write_cache


@dataclasses.dataclass(frozen=True)
class MPTConfig:
    """The reference MPTConfig's defaults for the fields the decoder reads."""

    vocab_size: int = 50368
    d_model: int = 2048
    n_layers: int = 24
    n_heads: int = 16
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    no_bias: bool = True
    alibi: bool = True
    alibi_bias_max: int = 8
    clip_qkv: Optional[float] = None
    qk_ln: bool = False
    multiquery: bool = False  # attn_type == 'multiquery_attention'
    logit_scale: Optional[float] = None
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def from_dict(cls, d: dict) -> "MPTConfig":
        """A HF config dict: ``attn_config``'s fields flattened, and
        ``logit_scale='inv_sqrt_d_model'`` resolved (JAX ``:43-88``)."""
        d = dict(d)
        attn = d.pop("attn_config", {}) or {}
        flat = {"alibi": attn.get("alibi", True),
                "alibi_bias_max": attn.get("alibi_bias_max", 8),
                "clip_qkv": attn.get("clip_qkv"),
                "qk_ln": attn.get("qk_ln", False),
                "multiquery": attn.get("attn_type", "") == "multiquery_attention"}
        known = {f.name for f in dataclasses.fields(cls)}
        flat.update({k: v for k, v in d.items() if k in known})
        if flat.get("logit_scale") == "inv_sqrt_d_model":
            flat["logit_scale"] = 1.0 / math.sqrt(flat.get("d_model", cls.d_model))
        elif isinstance(flat.get("logit_scale"), str):
            raise ValueError(f"unknown logit_scale string: {flat['logit_scale']!r}")
        return cls(**flat)


def alibi_slopes(n_heads: int, alibi_bias_max: int = 8) -> torch.Tensor:
    """MPT's ``gen_slopes``: geometric over the next power of two of the
    heads, interleaved when the heads are not a power of two."""
    n2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, n2 + 1, dtype=torch.float32) * (alibi_bias_max / n2)
    slopes = 1.0 / torch.pow(2.0, m)
    if n2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes


def alibi_key_bias(n_heads: int, max_len: int, alibi_bias_max: int = 8,
                   device=None) -> torch.Tensor:
    """(1, H, 1, max_len) causal ALiBi bias over absolute key index j:
    slopes · (j - (max_len - 1)), the reference's values up to a per-row
    constant that the softmax drops."""
    rel = torch.arange(max_len, dtype=torch.float32) - (max_len - 1)
    return (alibi_slopes(n_heads, alibi_bias_max)[:, None, None] * rel)[None].to(device)


class MPTLayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics and an optional bias (LPLayerNorm)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), b,
                            self.eps).to(x.dtype)


class MPTAttention(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.cfg = cfg
        hkv = 1 if cfg.multiquery else cfg.n_heads
        bias = not cfg.no_bias
        self.Wqkv = nn.Linear(cfg.d_model, cfg.d_model + 2 * hkv * cfg.head_dim, bias=bias)
        if cfg.qk_ln:
            self.q_ln = MPTLayerNorm(cfg.d_model, cfg.layer_norm_eps, bias=bias)
            self.k_ln = MPTLayerNorm(hkv * cfg.head_dim, cfg.layer_norm_eps, bias=bias)
        self.out_proj = nn.Linear(cfg.d_model, cfg.d_model, bias=bias)

    def forward(self, y, kv_cache, cache_index, mask):
        cfg = self.cfg
        h, d = cfg.n_heads, cfg.head_dim
        hkv = 1 if cfg.multiquery else h
        qkv = self.Wqkv(y)
        if cfg.clip_qkv:
            qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
        q, k, v = qkv.split([cfg.d_model, hkv * d, hkv * d], dim=-1)
        if cfg.qk_ln:  # over the packed projections, before the head split
            q, k = self.q_ln(q), self.k_ln(k)
        b, s, _ = y.shape
        split = lambda t, n: t.reshape(b, s, n, d).transpose(1, 2)
        q, k, v = split(q, h), split(k, hkv), split(v, hkv)
        if kv_cache is not None:
            k, v = write_cache(kv_cache, k, v, cache_index)
        o = attend(q, k, v, mask, d ** -0.5)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, h * d))


class MPTFFN(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        bias = not cfg.no_bias
        self.up_proj = nn.Linear(cfg.d_model, cfg.expansion_ratio * cfg.d_model, bias=bias)
        self.down_proj = nn.Linear(cfg.expansion_ratio * cfg.d_model, cfg.d_model, bias=bias)

    def forward(self, y):
        return self.down_proj(F.gelu(self.up_proj(y)))


class MPTBlock(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        bias = not cfg.no_bias
        self.norm_1 = MPTLayerNorm(cfg.d_model, cfg.layer_norm_eps, bias=bias)
        self.attn = MPTAttention(cfg)
        self.norm_2 = MPTLayerNorm(cfg.d_model, cfg.layer_norm_eps, bias=bias)
        self.ffn = MPTFFN(cfg)

    def forward(self, x, kv_cache, cache_index, mask):
        x = x + self.attn(self.norm_1(x), kv_cache, cache_index, mask)
        return x + self.ffn(self.norm_2(x))


class MPTModel(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model)
        if not cfg.alibi:
            self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        self.blocks = nn.ModuleList([MPTBlock(cfg) for _ in range(cfg.n_layers)])
        self.norm_f = MPTLayerNorm(cfg.d_model, cfg.layer_norm_eps, bias=not cfg.no_bias)

    def forward(self, x, positions, kv_caches, cache_index, mask):
        cfg = self.config
        if cfg.alibi:
            mask = mask + alibi_key_bias(cfg.n_heads, mask.shape[-1], cfg.alibi_bias_max,
                                         x.device)
        else:
            x = x + self.wpe(positions)[None].to(x.dtype)
        for i, block in enumerate(self.blocks):
            x = block(x, None if kv_caches is None else kv_caches[i], cache_index, mask)
        return self.norm_f(x)


class MPTForCausalLM(nn.Module):
    def __init__(self, config: MPTConfig = MPTConfig()):
        super().__init__()
        self.config = config
        self.transformer = MPTModel(config)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.transformer.wte(input_ids.long())

    def forward(self, inputs_embeds, positions, kv_caches, cache_index: int, mask):
        """As ``LlamaForCausalLM.forward``; the logits come from the shared
        embedding (times ``logit_scale`` when set)."""
        x = self.transformer(inputs_embeds, positions, kv_caches, cache_index, mask)
        logits = F.linear(x, self.transformer.wte.weight.to(x.dtype))
        scale = self.config.logit_scale
        return (logits if scale is None else logits * scale), kv_caches
