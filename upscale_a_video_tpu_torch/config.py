"""Model configurations (defaults are the released configs) and the device
rule shared by every entry point.

Mirror of ``upscale_a_video_tpu/config.py:21-111``; kept as an own copy so the
port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetVideoConfig:
    """UNetVideoModel's released config (ref unet_video.py:106-163)."""

    in_channels: int = 7
    out_channels: int = 4
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    attention_head_dim: int = 8
    block_out_channels: Tuple[int, ...] = (256, 512, 512, 1024)
    down_block_types: Tuple[str, ...] = (
        "DownBlock3D", "CrossAttnDownBlock3D", "CrossAttnDownBlock3D", "CrossAttnDownBlock3D",
    )
    up_block_types: Tuple[str, ...] = (
        "CrossAttnUpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D", "UpBlock3D",
    )
    only_cross_attention: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 1024
    use_linear_projection: bool = True
    num_class_embeds: Optional[int] = 1000
    down_temporal_idx: Tuple[int, ...] = (0, 1, 2, 3)
    mid_temporal: bool = True
    up_temporal_idx: Tuple[int, ...] = (0, 1, 2, 3)


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    """The released 3D VAE's decoder (ref configs/vae_3d_config.json); the
    video VAE's fields come with its slice of the port."""

    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.08333


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Asking for ``cuda`` on a host without a GPU
    raises; the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev
