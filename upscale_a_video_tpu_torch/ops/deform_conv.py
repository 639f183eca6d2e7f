"""Modulated deformable convolution (DCNv2) in plain PyTorch, channels last
(mirror of ``upscale_a_video_tpu/ops/deform_conv.py``; the reference calls
``torchvision.ops.deform_conv2d``, which the card's image does not have).

For each kernel tap k at dilated offset p_k the input is sampled bilinearly
at ``p + p_k + Δp_k(p)`` (a sample outside the frame adds 0), scaled by the
modulation mask m_k(p) and contracted with the weight slice of that tap.
All taps and deformable groups are gathered at once, then one fp32 einsum
(float64 for float64 inputs).

Layout: x (B, H, W, C_in); offset (B, H_out, W_out, 2·G·K) in torchvision's
channel order ([2·(g·K + k)] = Δy, [2·(g·K + k) + 1] = Δx); mask
(B, H_out, W_out, G·K); weight torch's (C_out, C_in, kh, kw).
"""

from __future__ import annotations

from typing import Optional

import torch

from .warp import compute_dtype


def _bilinear_taps(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, G, Cg) sampled at fractional (ys, xs) (B, Ho, Wo, G, K),
    each of the four corners 0 outside the frame → (B, Ho, Wo, G, K, Cg)."""
    b, h, w, g, cg = x.shape
    _, ho, wo, _, k = ys.shape
    src = x.permute(0, 3, 1, 2, 4).reshape(b, g, h * w, cg)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    y0, x0 = y0.long(), x0.long()

    def corner(iy, ix):
        valid = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).permute(0, 3, 1, 2, 4)
        out = torch.gather(src, 2, idx.reshape(b, g, -1, 1).expand(-1, -1, -1, cg))
        out = out.reshape(b, g, ho, wo, k, cg).permute(0, 2, 3, 1, 4, 5)
        return out * valid[..., None].to(out.dtype)

    return (corner(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
            + corner(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
            + corner(y0 + 1, x0) * (wy * (1 - wx))[..., None]
            + corner(y0 + 1, x0 + 1) * (wy * wx)[..., None])


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                  dilation: int = 1, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channels-last modulated deformable conv → (B, Ho, Wo, C_out) in x.dtype."""
    b, h, w, c_in = x.shape
    c_out, c_in_w, kh, kw = weight.shape
    if c_in_w != c_in:
        raise ValueError(f"weight {tuple(weight.shape)} for {c_in} input channels (channel "
                         f"groups are not supported, as in the JAX package)")
    k = kh * kw
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    g = offset.shape[-1] // (2 * k)
    if tuple(offset.shape) != (b, ho, wo, 2 * g * k):
        raise ValueError(f"offset {tuple(offset.shape)}, expected {(b, ho, wo, 2 * g * k)}")
    dt = compute_dtype(x, offset)
    off = offset.to(dt).reshape(b, ho, wo, g, k, 2)
    dev = x.device
    tap_y = (torch.arange(kh, device=dev)[:, None] * dilation).expand(kh, kw).reshape(k)
    tap_x = (torch.arange(kw, device=dev)[None, :] * dilation).expand(kh, kw).reshape(k)
    base_y = torch.arange(ho, dtype=dt, device=dev) * stride - padding
    base_x = torch.arange(wo, dtype=dt, device=dev) * stride - padding
    ys = base_y[None, :, None, None, None] + tap_y + off[..., 0]
    xs = base_x[None, None, :, None, None] + tap_x + off[..., 1]
    sampled = _bilinear_taps(x.to(dt).reshape(b, h, w, g, c_in // g), ys, xs)
    if mask is not None:
        sampled = sampled * mask.to(dt).reshape(b, ho, wo, g, k, 1)
    wt = weight.to(dt).reshape(c_out, g, c_in // g, k)
    out = torch.einsum("bhwgkc,ogck->bhwo", sampled, wt)
    if bias is not None:
        out = out + bias.to(dt)
    return out.to(x.dtype)
