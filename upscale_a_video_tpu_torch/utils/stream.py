"""The native frame ring of the serving stream (``csrc/frameproc.cpp``).

Port of ``FrameRing`` of ``upscale_a_video_tpu/utils/stream.py``: a fixed
number of fixed-size slots that a decode thread fills while the consumer
drains them, so a clip longer than the ring is never staged whole on the
host. The serving predictor's
streaming mode (``serving/predictor.py``) pushes decoded frame batches and
pops them in order.

The JAX package's ``make_ring`` falls back to a Python queue when its
native library is missing; the port's native frame code has no fallback
(``native_frameproc`` builds the library at first use or raises), so the
ring is built directly and there is nothing for ``make_ring`` to choose.
``ClipStreamer`` has no caller in either package's entry points and is not
ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
