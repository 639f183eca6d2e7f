"""Tracing and stage timing (port of ``upscale_a_video_tpu/utils/profiling.py``).

- :func:`annotate` names a span in a profile (``torch.profiler.record_function``);
- :func:`trace` profiles a block with ``torch.profiler`` (host and, on the
  card, CUDA activity) and writes a Chrome trace into a directory;
- :func:`device_seconds` reads each device kernel's time out of such a
  profile;
- :class:`StageTimer` adds up each stage's wall-clock seconds, the card
  synchronised on both sides of a stage so that its work is counted in it,
  and prints them as the JAX package's summary does.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional

import torch


def annotate(name: str):
    """A span named ``name`` in a ``torch.profiler`` trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: Optional[str], device="cuda", host: bool = True
          ) -> Iterator[torch.profiler.profile]:
    """Profile the block: host activity (unless ``host`` is False) and, when
    ``device`` is a CUDA device, the card's kernels. The profile is yielded
    (its ``key_averages()`` hold the times); with ``log_dir`` a Chrome trace
    (``*.pt.trace.json``) is written there when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU] if host else []
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = (torch.profiler.tensorboard_trace_handler(log_dir)
               if log_dir is not None else None)
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


def device_seconds(prof: torch.profiler.profile) -> Dict[str, float]:
    """Device seconds by the name of each kernel or operation that ran on
    the card in the profile (``key_averages``; names as demangled there)."""
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_time_total:
            out[e.key] = out.get(e.key, 0.0) + e.device_time_total / 1e6
    return out


class StageTimer:
    """Accumulates per-stage wall-clock seconds. On a CUDA ``device`` the
    card is synchronised before and after each stage (its queued work is
    counted in the stage that issued it); on the CPU nothing is."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.stages: "OrderedDict[str, float]" = OrderedDict()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        with annotate(name):
            yield
        self._sync()
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{'stage':<24}{'sec':>10}{'%':>8}"]
        for name, sec in self.stages.items():
            pct = 100.0 * sec / total if total else 0.0
            lines.append(f"{name:<24}{sec:>10.3f}{pct:>7.1f}%")
        lines.append(f"{'total':<24}{total:>10.3f}")
        return "\n".join(lines)
