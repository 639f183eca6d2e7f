"""Video quality metrics of the eval gate: PSNR, SSIM and LPIPS's distance.

Port of ``upscale_a_video_tpu/utils/metrics.py`` on torch tensors, with its
data range (2.0: frames in [-1, 1]) and reductions: per frame over
(H, W, C), in float32. SSIM uses the 11 x 11 Gaussian window (sigma 1.5,
k1 = 0.01, k2 = 0.03) over the valid region. ``lpips`` takes any feature
extractor that returns channels-last maps; ``utils/lpips.py`` is the
metric with its own backbones.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Per-frame PSNR in dB. a, b: (..., H, W, C) → (...)."""
    mse = (a.float() - b.float()).square().mean(dim=(-3, -2, -1)).clamp_min(1e-12)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Per-frame mean SSIM. a, b: (..., H, W, C) → (...)."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    lead = a.shape[:-3]
    h, w, c = a.shape[-3:]
    af = a.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    bf = b.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    window = _gaussian_window().to(af.device)[None, None].repeat(c, 1, 1, 1)
    blur = lambda x: F.conv2d(x, window, groups=c)  # depthwise, valid
    mu_a, mu_b = blur(af), blur(bf)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = blur(af * af) - mu_aa
    sig_b = blur(bf * bf) - mu_bb
    sig_ab = blur(af * bf) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / ((mu_aa + mu_bb + c1) * (sig_a + sig_b + c2))
    return s.mean(dim=(1, 2, 3)).reshape(lead)


def lpips(a: torch.Tensor, b: torch.Tensor,
          feature_fn: Optional[Callable[[torch.Tensor], List[torch.Tensor]]] = None
          ) -> torch.Tensor:
    """LPIPS-style distance with unit lin weights, given ``feature_fn`` that
    returns a list of (B, H, W, C) feature maps; raises without one (the
    pretrained backbones are not in the repository)."""
    if feature_fn is None:
        raise ValueError("lpips requires a pretrained feature extractor (e.g. AlexNet's); "
                         "pass feature_fn")
    total = 0.0
    for xa, xb in zip(feature_fn(a), feature_fn(b)):
        na = xa / torch.sqrt(xa.square().sum(dim=-1, keepdim=True) + 1e-10)
        nb = xb / torch.sqrt(xb.square().sum(dim=-1, keepdim=True) + 1e-10)
        total = total + (na - nb).square().mean(dim=(1, 2, 3))
    return total
