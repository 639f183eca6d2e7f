"""The native frame ring (``csrc/frameproc.cpp``) and the multi-clip
streamer over it.

Port of ``upscale_a_video_tpu/utils/stream.py``. ``FrameRing``: a fixed
number of fixed-size slots that a decode thread fills while the consumer
drains them, so a clip longer than the ring is never staged whole on the
host; the serving predictor's streaming mode (``serving/predictor.py``)
pushes decoded frame batches and pops them in order. ``ClipStreamer``: one
decode thread reads many clips in path order through one ring and yields
``(path, clip_index, frames)``; a clip that fails to read is reported and
skipped, as in the reference's per-video loop.

The JAX package's ``make_ring`` falls back to a Python queue when its
native library is missing; the port's native frame code has no fallback
(``native_frameproc`` builds the library at first use or raises), so both
build the ring directly and there is nothing for ``make_ring`` to choose.
"""

from __future__ import annotations

import ctypes
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from . import native_frameproc


class FrameRing:
    """Fixed-slot frame ring over the native buffer, FIFO in reserve order.
    ``timeout_ms`` < 0 waits without limit."""

    def __init__(self, slots: int, frame_shape: Tuple[int, ...], dtype=np.uint8):
        self._lib = native_frameproc.lib()
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.slot_bytes = int(np.prod(frame_shape)) * self.dtype.itemsize
        self._h = self._lib.fp_ring_create(slots, self.slot_bytes)
        if not self._h:
            raise ValueError(f"bad ring geometry: {slots} slots of {self.slot_bytes} bytes")

    def _view(self, ticket: int) -> np.ndarray:
        buf = (ctypes.c_char * self.slot_bytes).from_address(self._lib.fp_ring_slot(self._h,
                                                                                    ticket))
        return np.frombuffer(buf, dtype=self.dtype).reshape(self.frame_shape)

    def push(self, frame: np.ndarray, timeout_ms: int = -1) -> bool:
        """Copy one frame in (blocks while the ring is full). False on a
        timeout or once the ring is closed."""
        if np.shape(frame) != self.frame_shape:  # checked before a slot is reserved
            raise ValueError(f"frame of shape {np.shape(frame)}, the ring holds "
                             f"{self.frame_shape}")
        t = self._lib.fp_ring_reserve(self._h, timeout_ms)
        if t < 0:
            return False
        self._view(t)[...] = frame
        self._lib.fp_ring_commit(self._h, t)
        return True

    def pop(self, timeout_ms: int = -1) -> Optional[np.ndarray]:
        """Copy the oldest frame out; None on a timeout, or once the ring is
        closed and drained."""
        t = self._lib.fp_ring_pop(self._h, timeout_ms)
        if t < 0:
            return None
        out = self._view(t).copy()
        self._lib.fp_ring_release(self._h, t)
        return out

    def pending(self) -> int:
        """Frames pushed and not yet popped."""
        return int(self._lib.fp_ring_pending(self._h))

    def close(self) -> None:
        """No more pushes; a blocked push or pop wakes up."""
        self._lib.fp_ring_close(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.fp_ring_destroy(h)
            self._h = None


class ClipStreamer:
    """Decode many clips through one ring; yield normalised clip arrays.

    ``reader(path)`` yields (T, H, W, C) uint8 frame batches (by default
    ``video_io.read_video``'s frames in one batch). Clips are streamed in
    path order, one item per batch: the ring's unit is a frame of
    ``frame_shape``, so a short clip does not stall behind a long one. With
    ``normalize`` the frames come out as float32 in [-1, 1]
    (``native_frameproc.normalize_u8``), else as uint8."""

    def __init__(self, paths: Sequence[str], frame_shape: Tuple[int, ...], slots: int = 8,
                 reader: Optional[Callable] = None, normalize: bool = True):
        self.paths = list(paths)
        self.normalize = normalize
        self.ring = FrameRing(slots, frame_shape, np.uint8)
        self._meta: "queue.Queue" = queue.Queue()
        self._reader = reader or _default_reader
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        for pi, path in enumerate(self.paths):
            try:
                for frames in self._reader(path):
                    if tuple(np.shape(frames)[1:]) != self.ring.frame_shape:
                        # checked before the batch is announced, or the
                        # consumer would wait for frames never pushed
                        raise ValueError(f"frames of shape {np.shape(frames)[1:]}, the ring "
                                         f"holds {self.ring.frame_shape}")
                    self._meta.put((path, pi, len(frames), None))
                    for f in frames:
                        self.ring.push(f)
            except Exception as e:  # noqa: BLE001  a bad clip must not end the run
                self._meta.put((path, pi, 0, e))
        self._meta.put(None)
        self.ring.close()

    def __iter__(self) -> Iterator[Tuple[str, int, np.ndarray]]:
        while True:
            meta = self._meta.get()
            if meta is None:
                return
            path, pi, count, err = meta
            if err is not None:
                # the reference prints and goes on after a failed video
                # (ref inference_upscale_a_video.py:307-321)
                print(f"stream: skipping {path}: {err}")
                continue
            frames = [self.ring.pop() for _ in range(count)]
            clip = np.stack([f for f in frames if f is not None])
            yield path, pi, native_frameproc.normalize_u8(clip) if self.normalize else clip


def _default_reader(path: str):
    from .video_io import read_video

    frames, _fps, _name = read_video(path)
    yield np.asarray(frames, np.uint8)
