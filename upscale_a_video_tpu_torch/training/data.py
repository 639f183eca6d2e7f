"""Training data: real-world degradations of HR clips and the diffusion
batch (mirror of ``upscale_a_video_tpu/training/data.py``).

The first-order RealBasicVSR chain of the paper (arXiv 2312.06640): blur →
×1/scale bilinear resize → Gaussian noise → a compression-artifact proxy,
as batched tensor ops on the clips' device. Randomness comes from an
explicit ``torch.Generator``; :func:`draw_degradations` is the seam where a
caller (a test replaying JAX's draws) passes the draws instead.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.resize import resize_2d


def blur_kernels(sigma: torch.Tensor, kernel_size: int = 21) -> torch.Tensor:
    """(B,) sigmas → (B, K, K) normalised separable Gaussian kernels."""
    half = kernel_size // 2
    grid = torch.arange(kernel_size, dtype=torch.float32, device=sigma.device) - half
    s = sigma.float().clamp(min=1e-3)[:, None]
    k1 = torch.exp(-(grid[None] ** 2) / (2 * s ** 2))
    k1 = k1 / k1.sum(dim=-1, keepdim=True)
    return k1[:, :, None] * k1[:, None, :]


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor, kernel_size: int = 21) -> torch.Tensor:
    """Depthwise Gaussian blur with edge padding, one sigma per clip.
    x: (B, T, H, W, C); sigma (B,)."""
    b, t, h, w, c = x.shape
    half = kernel_size // 2
    kernels = blur_kernels(sigma, kernel_size).to(x.dtype)
    out = []
    for i in range(b):
        frames = F.pad(x[i].permute(0, 3, 1, 2), (half, half, half, half), mode="replicate")
        weight = kernels[i][None, None].expand(c, 1, kernel_size, kernel_size)
        out.append(F.conv2d(frames, weight, groups=c).permute(0, 2, 3, 1))
    return torch.stack(out)


def add_gaussian_noise(x: torch.Tensor, sigma: torch.Tensor,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x + noise · sigma, one level (B,) per clip in [0, 1] value units;
    ``noise`` (x's shape) is drawn from ``generator`` when not given."""
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x + noise * sigma.to(x.dtype)[:, None, None, None, None]


def jpeg_like_artifacts(x: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """Blocking without a JPEG codec: each 8×8 block mixed with its mean,
    ``q · x + (1 - q) · mean``; quality (B,) in [0, 1], 1 = unchanged. A
    ragged edge past the last whole block is left as it is."""
    b, t, h, w, c = x.shape
    h8, w8 = h // 8 * 8, w // 8 * 8
    blocks = x[:, :, :h8, :w8].reshape(b, t, h8 // 8, 8, w8 // 8, 8, c)
    means = blocks.mean(dim=(3, 5), keepdim=True)
    q = quality.to(x.dtype).reshape(b, 1, 1, 1, 1, 1, 1)
    out = x.clone()
    out[:, :, :h8, :w8] = (q * blocks + (1 - q) * means).reshape(b, t, h8, w8, c)
    return out


def draw_degradations(b: int, lr_shape: Tuple[int, ...], generator: Optional[torch.Generator],
                      device, blur_sigma_range=(0.2, 3.0), noise_range=(0.0, 0.1),
                      quality_range=(0.6, 1.0)) -> Dict[str, torch.Tensor]:
    """The draws of :func:`degrade_clip` from ``generator``: per clip a blur
    sigma, a noise level and a quality, each uniform in its range, and the
    unit Gaussian noise of the LR clip."""
    def uniform(lo, hi):
        return torch.rand(b, generator=generator, device=device) * (hi - lo) + lo

    sigma = uniform(*blur_sigma_range)
    noise_sigma = uniform(*noise_range)
    noise = torch.randn(lr_shape, generator=generator, device=device)
    return {"sigma": sigma, "noise_sigma": noise_sigma, "noise": noise,
            "quality": uniform(*quality_range)}


def degrade_clip(hr: torch.Tensor, scale: int = 4,
                 blur_sigma_range: Tuple[float, float] = (0.2, 3.0),
                 noise_range: Tuple[float, float] = (0.0, 0.1),
                 quality_range: Tuple[float, float] = (0.6, 1.0),
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """HR (B, T, 4h, 4w, 3) in [-1, 1] → degraded LR (B, T, h, w, 3): blur →
    ×1/scale bilinear resize → noise → compression artifacts, clipped to
    [-1, 1]. ``draws`` (:func:`draw_degradations`' keys) replaces the draws
    from ``generator``."""
    b, t, hh, ww, c = hr.shape
    lr_hw = (hh // scale, ww // scale)
    if draws is None:
        draws = draw_degradations(b, (b, t, *lr_hw, c), generator, hr.device, blur_sigma_range,
                                  noise_range, quality_range)
    lr = resize_2d(gaussian_blur(hr, draws["sigma"]), lr_hw, "bilinear")
    lr = add_gaussian_noise(lr, draws["noise_sigma"], draws["noise"].to(lr.dtype))
    return jpeg_like_artifacts(lr, draws["quality"]).clamp(-1.0, 1.0)


def make_train_batch(hr_clips: torch.Tensor, vae_encode: Callable[[torch.Tensor], torch.Tensor],
                     text_embeds: torch.Tensor, scaling_factor: float, scale: int = 4,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The diffusion batch of :mod:`.train_unet`: ``latents`` (the HR clips
    through ``vae_encode``, times ``scaling_factor``), ``low_res`` (the
    degraded clips) and ``text_embeds``."""
    low_res = degrade_clip(hr_clips, scale=scale, generator=generator, draws=draws)
    latents = vae_encode(hr_clips) * scaling_factor
    return {"latents": latents, "low_res": low_res, "text_embeds": text_embeds}
