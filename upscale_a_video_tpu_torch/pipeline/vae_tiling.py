"""VAE-level tiled encode/decode with seam blending
(ref autoencoder_kl_cond_video.py:228-333).

Port of ``upscale_a_video_tpu/pipeline/vae_tiling.py`` on torch tensors, with
the reference's semantics:
- tiled_encode: 256px sample tiles with 25% overlap (overlap stride 192),
  encoded tiles seam-blended in latent space over 16 rows/cols, cropped to 48.
- tiled_decode: the reference *overrides* its own tiling constants
  (:301-303): non-overlapping 256-latent tiles, decoded with the matching LR
  condition crops, then crossfaded over 64·4 px at the seams (its blend_extent
  stays the one derived from the sample size).

No pipeline calls these (as in the JAX package); the tests hold them.
Channels-last: x (B, T, H, W, C).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _blend_v(a: torch.Tensor, b: torch.Tensor, blend_extent: int) -> torch.Tensor:
    """Crossfade the top `be` rows of b with the bottom `be` rows of a
    (ref :228-231). a/b: (B, T, H, W, C)."""
    be = min(a.shape[2], b.shape[2], blend_extent)
    if be <= 0:
        return b
    ramp = (torch.arange(be, dtype=torch.float32, device=b.device)
            / blend_extent)[None, None, :, None, None]
    # row y of b blends with row (-blend_extent + y) of a (ref :230)
    top = a[:, :, a.shape[2] - blend_extent: a.shape[2] - blend_extent + be]
    blended = top * (1.0 - ramp) + b[:, :, :be] * ramp
    return torch.cat([blended.to(b.dtype), b[:, :, be:]], dim=2)


def _blend_h(a: torch.Tensor, b: torch.Tensor, blend_extent: int) -> torch.Tensor:
    """Crossfade the left `be` cols of b with the right `be` cols of a
    (ref :233-236)."""
    be = min(a.shape[3], b.shape[3], blend_extent)
    if be <= 0:
        return b
    ramp = (torch.arange(be, dtype=torch.float32, device=b.device)
            / blend_extent)[None, None, None, :, None]
    left = a[:, :, :, a.shape[3] - blend_extent: a.shape[3] - blend_extent + be]
    blended = left * (1.0 - ramp) + b[:, :, :, :be] * ramp
    return torch.cat([blended.to(b.dtype), b[:, :, :, be:]], dim=3)


def _stitch(rows, blend_extent: int, row_limit: int) -> torch.Tensor:
    """Blend each tile with its upper and left neighbours and crop it to
    ``row_limit`` rows and columns."""
    result_rows = []
    for i, row in enumerate(rows):
        result_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, blend_extent)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, blend_extent)
            result_row.append(tile[:, :, :row_limit, :row_limit])
        result_rows.append(torch.cat(result_row, dim=3))
    return torch.cat(result_rows, dim=2)


def tiled_encode_moments(encode_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                         tile_sample_min_size: int = 256, tile_latent_min_size: int = 64,
                         tile_overlap_factor: float = 0.25) -> torch.Tensor:
    """Tiled encoder → gaussian moments (ref tiled_encode :238-283).

    encode_fn: full (non-tiled) encode to moments, (B,T,h',w',2L).
    """
    overlap_size = int(tile_sample_min_size * (1 - tile_overlap_factor))
    blend_extent = int(tile_latent_min_size * tile_overlap_factor)
    row_limit = tile_latent_min_size - blend_extent
    rows = [[encode_fn(x[:, :, i:i + tile_sample_min_size, j:j + tile_sample_min_size])
             for j in range(0, x.shape[3], overlap_size)]
            for i in range(0, x.shape[2], overlap_size)]
    return _stitch(rows, blend_extent, row_limit)


def tiled_decode(decode_fn: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
                 z: torch.Tensor, img: Optional[torch.Tensor] = None,
                 tile_latent_size: int = 256, blend_extent: int = 64,
                 scale: int = 4) -> torch.Tensor:
    """Tiled conditional decoder (ref tiled_decode :285-333): non-overlapping
    `tile_latent_size` latent tiles (the reference's :301-303 override),
    crossfaded at the seams over `blend_extent` output pixels.

    decode_fn(z_tile, img_tile) → decoded tile at ×scale.
    """
    n = tile_latent_size
    crop = lambda v, i, j: None if v is None else v[:, :, i:i + n, j:j + n]
    rows = [[decode_fn(crop(z, i, j), crop(img, i, j)) for j in range(0, z.shape[3], n)]
            for i in range(0, z.shape[2], n)]
    return _stitch(rows, blend_extent, n * scale)
