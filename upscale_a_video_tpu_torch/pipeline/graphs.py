"""The denoise loop as one CUDA graph: the port's counterpart of the JAX
pipeline's ``step_mode="scan"``, which runs all steps as one device program
(``upscale_a_video_tpu/pipeline/pipeline.py:413-429``).

A capture costs more than an eager run of the loop, and a replay saves only
the host's share of one, so a graph must be replayed several times to pay
for itself. :class:`LoopGraphs` therefore captures only keys that come back
(:meth:`LoopGraphs.plan`): the first call of a key runs the loop eagerly on
the stream the capture will use and returns that result; the run also
loads the kernel library and fills the kernel operands cached on the
weights, the per-(T, device) tables and the library handles of that stream,
none of which may be made while a stream captures. A key seen a second time
is captured (:class:`CapturedLoop`) and replayed; later calls replay. Every
per-step choice (the timesteps, the propagation steps, the Pyramid
Attention Broadcast flags) is a Python constant fixed at capture, so a graph
stands for one key. Inputs are copied into static buffers made before the
capture; the output is cloned out of the graph's memory pool.

The graph's pool stays reserved while the graph is held, and the decode
cannot use it: a pipeline holds one graph, the newest.

The graph holds the addresses of the weights and of the operands made from
them (and the kernels' TMA descriptors that encode them): the pipeline
drops the graph when it moves a module, and a change of
:func:`weights_stamp`, which an in-place load makes, drops it too. A failed
capture or replay raises; nothing falls back to the step-by-step loop.

``_cuda.LAUNCHES`` counts a wrapper's launches when its Python runs: an
eager call and a capturing call each count the loop once (the capture's
alone are in :attr:`CapturedLoop.launches`), a replay counts none.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from ..ops import _cuda


def weights_stamp(module: torch.nn.Module) -> Tuple[Tuple[int, int], ...]:
    """``(data_ptr, _version)`` of every parameter and buffer: changed by a
    move to new storage and by an in-place write such as
    ``load_state_dict``'s copy (as ``_cuda.cached`` stamps its operands)."""
    return tuple((t.data_ptr(), t._version) for t in (*module.parameters(), *module.buffers()))


class CapturedLoop:
    """``fn(*inputs) -> tensor`` captured once as a CUDA graph on
    ``stream``, on which ``fn`` has already run eagerly at these shapes."""

    def __init__(self, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                 stream: torch.cuda.Stream):
        self.static = [x.clone() for x in inputs]  # outside the graph's pool
        stream.wait_stream(torch.cuda.current_stream())
        before = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):  # a pool of its own
            self.out = fn(*self.static)
        self.capture_s = time.perf_counter() - t0
        self.launches: Dict[str, int] = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                                         if v != before[k]}

    def __call__(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        for buf, x in zip(self.static, inputs):
            if buf.shape != x.shape or buf.dtype != x.dtype:
                raise ValueError(f"captured loop input {tuple(buf.shape)} {buf.dtype}, given "
                                 f"{tuple(x.shape)} {x.dtype}")
            buf.copy_(x)
        self.graph.replay()
        return self.out.clone()


class LoopGraphs:
    """A pipeline's captured loop (the newest) and the keys run eagerly
    since it last ran."""

    def __init__(self):
        self.key: Optional[Hashable] = None
        self.loop: Optional[CapturedLoop] = None
        self.stamp = None
        self.seen: Dict[Hashable, int] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def clear(self) -> None:
        self.key = self.loop = self.stamp = None
        self.seen.clear()

    def plan(self, key: Hashable, stamp) -> str:
        """``"replay"`` for the held graph's key; ``"capture"`` for a key
        that comes the second time since the held graph last ran (it then
        replaces that graph); else ``"eager"``. A key that alternates with
        the held one (the last, smaller batch of a clip's tiles) stays
        eager and never evicts it. New weights drop everything."""
        if stamp != self.stamp:
            self.clear()
            self.stamp = stamp
        if key == self.key:
            self.seen.clear()
            return "replay"
        self.seen[key] = self.seen.get(key, 0) + 1
        return "capture" if self.seen[key] >= 2 else "eager"

    def run(self, key: Hashable, stamp, fn: Callable[..., torch.Tensor],
            inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        how = self.plan(key, stamp)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=inputs[0].device)
        if how == "eager":
            return self._eager(fn, inputs)
        if how == "capture":
            self.key = self.loop = None  # the held graph and its pool go first
            self.loop = CapturedLoop(fn, inputs, self._stream)
            self.key = key
            self.seen.clear()
        return self.loop(inputs)

    def _eager(self, fn, inputs) -> torch.Tensor:
        """``fn(*inputs)`` on the capture's stream, ordered after the
        caller's work and before what the caller does next."""
        caller, stream = torch.cuda.current_stream(), self._stream
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            out = fn(*inputs)
        caller.wait_stream(stream)
        out.record_stream(caller)
        return out
