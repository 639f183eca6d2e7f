"""Host-to-device prefetch (mirror of ``upscale_a_video_tpu/utils/prefetch.py``):
a feeder thread reads, transforms and copies the next items to the device
while the caller works on the current one.

Order is kept, and an error raised by the source or the transform is raised
again at the consumer after the items before it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..config import resolve_device


def to_device(item, device: torch.device):
    """Tensors and numpy arrays of a (nested) dict, list or tuple copied to
    ``device`` (pinned first when the device is a card, so the copy runs
    asynchronously); other leaves as they are."""
    if isinstance(item, dict):
        return {k: to_device(v, device) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(to_device(v, device) for v in item)
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(np.ascontiguousarray(item))
    if isinstance(item, torch.Tensor):
        if device.type == "cuda" and item.device.type == "cpu":
            return item.pin_memory().to(device, non_blocking=True)
        return item.to(device)
    return item


def device_prefetch(iterable: Iterable, buffer_size: int = 2, device=None,
                    transform: Optional[Callable] = None) -> Iterator:
    """Yield the items of ``iterable`` with their arrays on ``device`` (the
    card unless ``device="cpu"``), up to ``buffer_size`` items ahead.
    ``transform`` runs in the feeder thread before the copy."""
    dev = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    done = object()
    failed = []

    def feed():
        try:
            for item in iterable:
                if transform is not None:
                    item = transform(item)
                q.put(to_device(item, dev))
        except Exception as e:  # raised again at the consumer, in order
            failed.append(e)
        finally:
            q.put(done)

    threading.Thread(target=feed, daemon=True, name="device_prefetch").start()
    while True:
        item = q.get()
        if item is done:
            if failed:
                raise failed[0]
            return
        yield item


class ClipPrefetcher:
    """Clips read from ``paths`` and put in the model's range, (1, T, H, W, 3)
    fp32 on the device, while the caller processes the previous clip:
    items ``{"frames", "fps", "name"}``."""

    def __init__(self, paths, buffer_size: int = 2, max_frames: Optional[int] = None,
                 device=None):
        from . import video_io

        def clips():
            for path in paths:
                frames_u8, fps, name = video_io.read_video(path)
                if max_frames:
                    frames_u8 = frames_u8[:max_frames]
                yield {"frames": video_io.to_model_range(frames_u8)[None], "fps": fps,
                       "name": name}

        self._it = device_prefetch(clips(), buffer_size=buffer_size, device=device)

    def __iter__(self):
        return self._it
