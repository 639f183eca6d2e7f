"""CLIP text tower (mirror of ``upscale_a_video_tpu/models/clip_text.py``;
OpenCLIP ViT-H text config of the x4 upscaler). Key names follow the HF
state dict (``embeddings.*``, ``encoder.layers.N.*``, ``final_layer_norm``)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import LayerNorm
from ..ops.attention import attention_plain


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        split = lambda t: t.reshape(b, s, self.heads, c // self.heads).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        out = attention_plain(q, k, v, (c // self.heads) ** -0.5, bias=mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class CLIPTextModel(nn.Module):
    """input_ids (B, S) → final hidden states (B, S, hidden)."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)
        self.final_layer_norm = LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        b, s = input_ids.shape
        emb = self.embeddings
        x = emb.token_embedding(input_ids.long()) + emb.position_embedding.weight[None, :s]
        mask = torch.triu(torch.full((s, s), -3.4e38, device=x.device), diagonal=1)[None, None]
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x)
