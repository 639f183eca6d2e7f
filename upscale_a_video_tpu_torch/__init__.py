"""PyTorch/CUDA port of the video upscaler, for one NVIDIA Hopper GPU.

The JAX package ``upscale_a_video_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). Public tensors are channels-last
``(B, T, H, W, C)`` as in the reference. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on the CPU every hand-written kernel is
replaced by its plain PyTorch version.
"""

from .config import VIDEO_VAE, UNetVideoConfig, VaeConfig, resolve_device

__all__ = ["UNetVideoConfig", "VaeConfig", "VIDEO_VAE", "resolve_device"]
