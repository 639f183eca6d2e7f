"""Per-clip resume of a batch run: ``ClipLedger``.

Port of ``ClipLedger`` in ``upscale_a_video_tpu/utils/checkpoint.py``: a
JSON-lines ledger of the clips a run has finished, written and synced one
line per clip, so that a run that stopped resumes at the first clip it had
not finished (the eval harness, ``pipeline/eval.py``). A seeded generator
makes the re-run of a clip give the same output. The JAX module's
``save_params``/``load_params`` (an Orbax cache of converted weights) have
no counterpart: the port reads the released torch files directly.
"""

from __future__ import annotations

import json
import os
from typing import List


class ClipLedger:
    """Crash-safe record of finished work items."""

    def __init__(self, path: str):
        self.path = path
        self._done = set()
        if os.path.exists(path):
            with open(path) as f:
                self._done = {json.loads(line)["clip"] for line in f if line.strip()}

    def is_done(self, clip: str) -> bool:
        return clip in self._done

    def mark_done(self, clip: str, **meta) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps({"clip": clip, **meta}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._done.add(clip)

    def pending(self, clips: List[str]) -> List[str]:
        return [c for c in clips if c not in self._done]
