"""Sharded VAE decode: the reference's 3-frame decode chunks spread over
ranks (port of ``upscale_a_video_tpu/parallel/decode.py``).

The reference decodes the latents chunk by chunk in fp32 (ref
pipeline_upscale_a_video.py:668,685-700). The chunks are independent
programs over disjoint frames (the decoder's temporal coupling acts within
a chunk, which is why the chunking carries meaning and is kept):

- the ``T // chunk`` full chunks are dealt out round-robin in blocks, each
  rank decoding its share one chunk at a time, the very calls the serial
  decode makes;
- one all-gather reassembles the upscaled frames on every rank;
- a short remainder chunk (T % chunk ≠ 0) is decoded on every rank, which
  costs less than any exchange and is the serial tail decode itself.

Ranks whose share runs past the last chunk decode the last chunk again and
drop it, so every rank decodes as many chunks and gathers as much. The
output equals ``VideoUpscalePipeline.decode_latents`` bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import all_gather, axis_group


def build_sharded_decode(vae, mesh, num_frames: int, chunk: int = 3, axis: str = "win",
                         w_lr: float = 1.0):
    """``decode(latents, image_dec) -> video``: latents (B, T, H, W, C) and,
    for a VAE conditioned on the LR frames, ``image_dec`` (B, T, H, W, 3),
    both whole on every rank of ``mesh``'s ``axis`` → (B, T, 4H, 4W, 3)
    float32 in [-1, 1] on every rank. The VAE decodes in its own dtype (JAX's
    ``decode_dtype`` is the dtype the port's VAE was built in)."""
    group, n_dev, rank = axis_group(mesh, axis)
    scaling = vae.config.scaling_factor
    cond = vae.config.condition_img
    n_full = num_frames // chunk
    rem = num_frames - n_full * chunk
    cpd = max(1, -(-n_full // n_dev))  # chunks a rank (at least one when T < chunk)
    ids = [min(rank * cpd + j, max(n_full - 1, 0)) for j in range(cpd)]

    def one(latents, image_dec, s, e):
        """The serial decode's call on frames [s, e)."""
        z = latents[:, s:e] / scaling
        img = image_dec[:, s:e] if cond else None
        return vae.decode(z, img, w_lr).float().clamp(-1.0, 1.0)

    @torch.no_grad()
    def decode(latents: torch.Tensor, image_dec: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cond and image_dec is None:
            raise ValueError("the VAE is conditioned on the LR frames: pass image_dec")
        if latents.shape[1] != num_frames:
            raise ValueError(f"built for {num_frames} frames, given {latents.shape[1]}")
        parts = []
        if n_full > 0:
            local = torch.stack([one(latents, image_dec, c * chunk, (c + 1) * chunk)
                                 for c in ids])                  # (cpd, B, chunk, ...)
            full = all_gather(local, n_dev, group).flatten(0, 1)[:n_full]
            parts.append(full.movedim(0, 1).flatten(1, 2))      # (B, n_full·chunk, ...)
        if rem:
            parts.append(one(latents, image_dec, n_full * chunk, num_frames))
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    return decode
