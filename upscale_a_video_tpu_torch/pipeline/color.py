"""Colour correction after the pipeline (mirror of
``upscale_a_video_tpu/pipeline/color.py:32-122``): the colour statistics of
the bicubic-upsampled LR clip are moved onto the upscaled output, by AdaIN
per-channel moments or by swapping the low-frequency band of a 5-level
dilated-Gaussian "wavelet" decomposition. Channels-last (..., H, W, C).
As in the CLI, the caller applies the fix to the pipeline's output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.resize import resize_2d


def _calc_mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """Per-channel spatial mean and std (unbiased variance, as torch's
    ``Tensor.var``); feat (B, H, W, C) → two (B, 1, 1, C)."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    var = flat.var(dim=1) if h * w > 1 else torch.zeros_like(flat[:, 0])
    return flat.mean(dim=1)[:, None, None, :], torch.sqrt(var + eps)[:, None, None, :]


def adain_color_fix(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """AdaIN moment transfer (ref :59-71). content/style: (B, H, W, C)."""
    style_mean, style_std = _calc_mean_std(style)
    content_mean, content_std = _calc_mean_std(content)
    return (content - content_mean) / content_std * style_std + style_mean


def _wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """3×3 Gaussian blur dilated by ``radius``, replicate padding, per channel
    (ref :73-92). image: (B, H, W, C)."""
    c = image.shape[-1]
    kernel = torch.tensor([[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125],
                           [0.0625, 0.125, 0.0625]], dtype=image.dtype, device=image.device)
    x = F.pad(image.permute(0, 3, 1, 2), (radius,) * 4, mode="replicate")
    y = F.conv2d(x, kernel.expand(c, 1, 3, 3), dilation=radius, groups=c)
    return y.permute(0, 2, 3, 1)


def wavelet_decomposition(image: torch.Tensor, levels: int = 5):
    """(high_freq, low_freq) bands (ref :94-106)."""
    high_freq = torch.zeros_like(image)
    low_freq = image
    for i in range(levels):
        blurred = _wavelet_blur(image, 2 ** i)
        high_freq = high_freq + (image - blurred)
        image = low_freq = blurred
    return high_freq, low_freq


def wavelet_color_fix(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """content's high-frequency bands + style's low-frequency band (ref :108-119)."""
    content_high, _ = wavelet_decomposition(content)
    _, style_low = wavelet_decomposition(style)
    return content_high + style_low


@torch.no_grad()
def apply_color_fix(mode: str, output: torch.Tensor, lr: torch.Tensor,
                    chunk_frames: int = 4) -> torch.Tensor:
    """Upsample the LR clip bicubically to the output's size and apply the
    ``"AdaIn"`` or ``"Wavelet"`` fix, ``chunk_frames`` frames at a time (both
    fixes are per frame, so chunking is exact and bounds the transient
    memory). Any other mode returns ``output`` unchanged.

    output: (T, 4H, 4W, C) upscaled frames, lr: (T, H, W, C) LR frames, both
    in model range. Returns fp32 frames of ``output``'s shape on its device.
    """
    output = torch.as_tensor(output)
    if mode not in ("AdaIn", "Wavelet"):
        return output
    fix = adain_color_fix if mode == "AdaIn" else wavelet_color_fix
    lr = torch.as_tensor(lr, device=output.device)
    oh, ow = output.shape[1], output.shape[2]
    fixed = torch.empty(output.shape, dtype=torch.float32, device=output.device)
    for s in range(0, output.shape[0], chunk_frames):
        sl = slice(s, s + chunk_frames)
        fixed[sl] = fix(output[sl].float(), resize_2d(lr[sl].float(), (oh, ow)))
    return fixed
