"""T5 relative-position buckets for the temporal bias (copy of
``upscale_a_video_tpu/ops/relpos.py``; the reference negates j - i)."""

from __future__ import annotations

import numpy as np


def relative_position_buckets(n: int, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """(n, n) int32 bucket ids for query i, key j."""
    rel = np.arange(n)[None, :] - np.arange(n)[:, None]
    neg = -rel
    nb = num_buckets // 2
    ret = (neg < 0).astype(np.int64) * nb
    mag = np.abs(neg)
    max_exact = nb // 2
    safe = np.maximum(mag, 1)
    large = max_exact + (np.log(safe.astype(np.float64) / max_exact)
                         / np.log(max_distance / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return (ret + np.where(mag < max_exact, mag, large)).astype(np.int32)
