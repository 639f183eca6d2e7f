"""The port's native frame ring (``utils/stream.py::FrameRing`` over its own
``csrc/frameproc.cpp``, built at first use): the ``FrameRing`` cases of
``tests/test_stream.py`` on the port's build — FIFO order, wrap-around with
blocking pushes, pop and push timeouts, ``close`` waking a blocked pop,
drain-then-None, commits out of order, ``pending``."""

import threading
import time

import numpy as np
import pytest

from upscale_a_video_tpu_torch.utils.stream import FrameRing


def test_fifo_roundtrip():
    ring = FrameRing(4, (2, 2), np.uint8)
    for i in range(3):
        assert ring.push(np.full((2, 2), i, np.uint8))
    assert ring.pending() == 3
    for i in range(3):
        np.testing.assert_array_equal(ring.pop(), np.full((2, 2), i))
    assert ring.pending() == 0


def test_wraparound_order_with_blocking_pushes():
    ring = FrameRing(2, (4,), np.uint8)
    out = []

    def consume():
        while (f := ring.pop()) is not None:
            out.append(int(f[0]))

    c = threading.Thread(target=consume)
    c.start()
    for i in range(20):  # 10x the slots: every slot reused, pushes block
        assert ring.push(np.full((4,), i, np.uint8))
    ring.close()
    c.join(timeout=10)
    assert out == list(range(20)) and ring.pending() == 0


def test_timeouts():
    ring = FrameRing(1, (1,))
    t0 = time.monotonic()
    assert ring.pop(timeout_ms=50) is None  # empty
    assert time.monotonic() - t0 >= 0.04
    assert ring.push(np.zeros(1, np.uint8))
    assert not ring.push(np.zeros(1, np.uint8), timeout_ms=50)  # full
    assert ring.pending() == 1


def test_close_wakes_a_blocked_pop():
    ring = FrameRing(2, (1,))
    got = []
    t = threading.Thread(target=lambda: got.append(ring.pop()))
    t.start()
    time.sleep(0.1)
    assert t.is_alive()  # blocked on the empty ring
    ring.close()
    t.join(timeout=5)
    assert not t.is_alive() and got == [None]


def test_closed_ring_drains_then_returns_none():
    ring = FrameRing(4, (1,))
    ring.push(np.array([7], np.uint8))
    ring.close()
    assert ring.pop()[0] == 7
    assert ring.pop() is None
    assert not ring.push(np.array([1], np.uint8))


def test_commits_out_of_order_pop_in_reserve_order():
    ring = FrameRing(8, (1,), np.uint8)
    lib, h = ring._lib, ring._h
    t0, t1 = lib.fp_ring_reserve(h, -1), lib.fp_ring_reserve(h, -1)
    ring._view(t1)[...] = 11
    lib.fp_ring_commit(h, t1)  # the newer ticket commits first
    assert ring.pending() == 0  # not visible before t0
    ring._view(t0)[...] = 10
    lib.fp_ring_commit(h, t0)
    assert ring.pending() == 2
    assert ring.pop()[0] == 10 and ring.pop()[0] == 11


@pytest.mark.parametrize("shape,dtype", [((8, 6, 10, 3), np.uint8), ((3, 5), np.float32)])
def test_slot_keeps_shape_and_dtype(shape, dtype):
    ring = FrameRing(2, shape, dtype)
    frame = np.random.default_rng(0).integers(0, 200, shape).astype(dtype)
    ring.push(frame)
    out = ring.pop()
    assert out.dtype == np.dtype(dtype) and out.shape == shape
    np.testing.assert_array_equal(out, frame)


def test_bad_geometry_and_frame_shape_raise():
    with pytest.raises(ValueError, match="ring geometry"):
        FrameRing(0, (4,))
    ring = FrameRing(1, (4,))
    with pytest.raises(ValueError, match="frame of shape"):
        ring.push(np.zeros(3, np.uint8))
    assert ring.push(np.zeros(4, np.uint8), timeout_ms=50)  # no slot was taken
