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
    """AutoencoderKLVideo's config (ref autoencoder_kl_cond_video.py:48-97).
    The defaults are the released 3D VAE (configs/vae_3d_config.json);
    :data:`VIDEO_VAE` is the released video VAE (configs/vae_video_config.json)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512)
    down_block_types: Tuple[str, ...] = ("DownEncoderBlock3D",) * 3
    up_block_types: Tuple[str, ...] = ("UpDecoderBlock3D",) * 3
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.08333
    condition_img: bool = False
    condition_channels: int = 128
    use_temporal_block: bool = False  # stored only, as the reference stores it

    @property
    def is_plus(self) -> bool:
        """Decoder blocks with the (3,3,3) temporal residual branch."""
        return self.up_block_types[0] == "UpDecoderBlock3D_plus"


VIDEO_VAE = VaeConfig(up_block_types=("UpDecoderBlock3D_plus",) * 3, condition_img=True,
                      condition_channels=128, use_temporal_block=True)


def config_from_dict(cls: type, d: dict):
    """A config dataclass from a released JSON's dict: keys the dataclass
    does not have are ignored, lists become tuples, and the UNet's single
    ``only_cross_attention`` flag is repeated per down block (as
    ``upscale_a_video_tpu/config.py:57-69`` reads them)."""
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in known}
    if isinstance(kwargs.get("only_cross_attention"), bool):
        n = len(kwargs.get("down_block_types", cls.down_block_types))
        kwargs["only_cross_attention"] = (kwargs["only_cross_attention"],) * n
    return cls(**kwargs)


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Asking for ``cuda`` on a host without a GPU
    raises; the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev
