"""CLIP vision tower of the captioner (mirror of
``upscale_a_video_tpu/models/llava/clip_vision.py``; ViT-L/14-336 by
default): patchify conv → class token + position embeddings → pre-LN
transformer, run to ``feature_layer`` (LLaVA takes the (-2)th layer's patch
tokens, CLS dropped). Key names are HF ``CLIPVisionTransformer``'s
(``embeddings.*``, ``pre_layrnorm``, ``encoder.layers.N.*``); the released
LLaVA checkpoint nests them under
``model.vision_tower.vision_tower.vision_model``."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...nn.blocks import LayerNorm
from ..clip_text import CLIPAttention


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @classmethod
    def from_dict(cls, d: dict) -> "CLIPVisionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


class _VisionMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(activation(self.act, self.fc1(x)))


class _VisionLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _VisionMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x), None)
        return x + self.mlp(self.layer_norm2(x))


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(c))
        self.patch_embedding = nn.Conv2d(3, c, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // p) ** 2 + 1, c)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList([_VisionLayer(cfg) for _ in range(n_layers)])


class CLIPVisionTower(nn.Module):
    """(B, H, W, 3) normalised pixels, channels last → (B, patches, hidden)
    from ``feature_layer`` (a negative index counts from the last layer).
    Only the layers up to that one exist, as in the JAX module (a released
    tower's later layers and ``post_layernorm`` are left unloaded)."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig(), feature_layer: int = -2):
        super().__init__()
        self.config = config
        n = config.num_hidden_layers
        self.embeddings = _VisionEmbeddings(config)
        self.pre_layrnorm = LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.encoder = _Encoder(config, (n + feature_layer if feature_layer < 0
                                         else feature_layer) + 1)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        dt = emb.patch_embedding.weight.dtype
        patches = emb.patch_embedding(pixels.to(dt).permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)  # row-major patches, as JAX's reshape
        cls = emb.class_embedding.to(dt).expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight[None].to(dt)
        x = self.pre_layrnorm(x)
        for layer in self.encoder.layers:
            x = layer(x)
        return x[:, 1:]
