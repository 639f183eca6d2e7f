"""Tiled pipeline execution (ref inference_upscale_a_video.py:230-304).

Port of ``upscale_a_video_tpu/pipeline/tiled_run.py`` on torch tensors:
tiles with the same padded shape go through the pipeline ``tile_batch`` at a
time along the batch axis, each with its crop of the whole clip's flows, and
are pasted back by ``plan_tiles``' arithmetic into one preallocated output
that stays on the clip's device. As the JAX runner passes one ``key`` to
every call, each call gets a fresh generator seeded with ``seed``, so every
call starts from the same noise stream.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Optional

import torch

from .tiling import plan_tiles


def run_tiled(pipeline, prompt: str, video: torch.Tensor, flows_bi=None, tile_size: int = 256,
              overlap: int = 64, tile_batch: int = 1, seed: int = 10,
              on_tile: Optional[Callable[[int, int], None]] = None,
              **call_kwargs) -> torch.Tensor:
    """video: (1, T, H, W, 3) → (1, T, 4H, 4W, 3) fp32 on ``video``'s device.
    ``call_kwargs`` go to every pipeline call; a string ``negative_prompt``
    is repeated for each tile of a call. ``on_tile(done, total)``, if given,
    runs after each call with the tiles pasted so far (the serving
    predictor's ``"tile"`` ticks)."""
    b, t, h, w, _ = video.shape
    if b != 1:
        raise ValueError(f"the tiled runner takes one clip, got a batch of {b}")
    specs = plan_tiles(h, w, tile_size, overlap)
    output = torch.zeros((1, t, h * 4, w * 4, 3), dtype=torch.float32, device=video.device)

    groups = defaultdict(list)
    for spec in specs:
        groups[spec.in_shape].append(spec)

    step = max(tile_batch, 1)
    done = 0
    for group in groups.values():
        for i in range(0, len(group), step):
            batch_specs = group[i:i + step]
            crop = lambda v: torch.cat([v[:, :, s.in_y0:s.in_y1, s.in_x0:s.in_x1]
                                        for s in batch_specs])
            tile_flows = None if flows_bi is None else tuple(crop(f) for f in flows_bi)
            kwargs = dict(call_kwargs)
            if isinstance(kwargs.get("negative_prompt"), str):
                kwargs["negative_prompt"] = [kwargs["negative_prompt"]] * len(batch_specs)
            generator = torch.Generator(device=video.device).manual_seed(seed)
            out = pipeline([prompt] * len(batch_specs), crop(video), tile_flows,
                           generator=generator, **kwargs)
            for j, s in enumerate(batch_specs):
                output[0, :, s.out_y0:s.out_y1, s.out_x0:s.out_x1] = \
                    out[j, :, s.tile_y0:s.tile_y1, s.tile_x0:s.tile_x1]
            done += len(batch_specs)
            if on_tile is not None:
                on_tile(done, len(specs))
    return output
