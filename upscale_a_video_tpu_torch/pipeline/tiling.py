"""Spatial tiling (ref inference_upscale_a_video.py:200-304).

Copy of ``upscale_a_video_tpu/pipeline/tiling.py`` (pure arithmetic). The
reference tiles inputs ≥384² into ``tile_size`` patches with a 64px halo,
runs the pipeline per tile, and pastes back the un-padded center with ×4
coordinate mapping. We reproduce the exact grid/edge arithmetic (including the
last-tile "rm_end_pad" quirks) as a static plan, so the CLI/runner can batch
same-shaped tiles along the data axis instead of looping.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class TileSpec:
    # input crop (with halo), in LR pixels
    in_y0: int
    in_y1: int
    in_x0: int
    in_x1: int
    # paste destination in the ×4 output
    out_y0: int
    out_y1: int
    out_x0: int
    out_x1: int
    # crop within the upscaled tile (×4 of the halo offset)
    tile_y0: int
    tile_y1: int
    tile_x0: int
    tile_x1: int

    @property
    def in_shape(self) -> Tuple[int, int]:
        return (self.in_y1 - self.in_y0, self.in_x1 - self.in_x0)


def needs_tiling(h: int, w: int, threshold: int = 384) -> bool:
    """Auto-tiling trigger (ref :201-202)."""
    return h * w >= threshold * threshold


def plan_tiles(
    h: int,
    w: int,
    tile_size: int = 256,
    overlap: int = 64,
    scale: int = 4,
) -> List[TileSpec]:
    """Static tile plan replicating the reference grid (ref :207-304)."""
    tiles_x = math.ceil(w / tile_size)
    tiles_y = math.ceil(h / tile_size)
    out_h, out_w = h * scale, w * scale

    rm_end_pad_w = rm_end_pad_h = True
    if (tiles_x - 1) * tile_size + overlap >= w:
        tiles_x -= 1
        rm_end_pad_w = False
    if (tiles_y - 1) * tile_size + overlap >= h:
        tiles_y -= 1
        rm_end_pad_h = False

    specs = []
    for y in range(tiles_y):
        for x in range(tiles_x):
            in_sx = x * tile_size
            in_ex = min(in_sx + tile_size, w)
            in_sy = y * tile_size
            in_ey = min(in_sy + tile_size, h)
            in_sx_pad = max(in_sx - overlap, 0)
            in_ex_pad = min(in_ex + overlap, w)
            in_sy_pad = max(in_sy - overlap, 0)
            in_ey_pad = min(in_ey + overlap, h)
            in_tw = in_ex - in_sx
            in_th = in_ey - in_sy

            out_sx = in_sx * scale
            out_ex = out_w if (x == tiles_x - 1 and not rm_end_pad_w) else in_ex * scale
            out_sy = in_sy * scale
            out_ey = out_h if (y == tiles_y - 1 and not rm_end_pad_h) else in_ey * scale

            t_sx = (in_sx - in_sx_pad) * scale
            t_ex = (t_sx + out_w - out_sx) if (x == tiles_x - 1 and not rm_end_pad_w) \
                else t_sx + in_tw * scale
            t_sy = (in_sy - in_sy_pad) * scale
            t_ey = (t_sy + out_h - out_sy) if (y == tiles_y - 1 and not rm_end_pad_h) \
                else t_sy + in_th * scale

            specs.append(TileSpec(
                in_y0=in_sy_pad, in_y1=in_ey_pad, in_x0=in_sx_pad, in_x1=in_ex_pad,
                out_y0=out_sy, out_y1=out_ey, out_x0=out_sx, out_x1=out_ex,
                tile_y0=t_sy, tile_y1=t_ey, tile_x0=t_sx, tile_x1=t_ex,
            ))
    return specs
