#!/usr/bin/env python3
"""Where a served key's CUDA-graph capture spends its time (ROADMAP fault C7).

The port's pipeline at the serving ``Predictor``'s settings (released widths
with seeded random weights, 3D VAE, bf16 decode, ``step_mode="scan"``; an
8-frame 64x64 clip, 30 steps, CFG 6, noise level 150) captures the same key
on three kinds of thread. Each time the held graph is dropped, and then on
one thread the key's first call runs eagerly and its second call captures
and replays; the capture is split into its recording (the loop's Python
inside ``torch.cuda.graph``) and its exit (``capture_end`` and the
instantiation):

- ``main``: the main thread, no other thread running;
- ``thread``: a new plain ``threading.Thread`` each time, in a process with
  no HTTP server;
- ``worker``: the serving worker's job thread (``serving/worker.py``), one
  job posted over HTTP running both calls, with the worker's
  ``ThreadingHTTPServer`` serving and its heartbeat thread beating against
  a controller in this process.

Each kind runs twice in a row, the worker's last: the controller and the
worker start only then. Run from the repository root on one H100:

    python3 scripts/torch_capture_threads.py

It prints the card's name and power limit and one line per capture, and
writes every number to ``chiprun_out/capture_threads.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from upscale_a_video_tpu_torch.pipeline import load_pipeline  # noqa: E402
from upscale_a_video_tpu_torch.serving.controller import serve_controller  # noqa: E402
from upscale_a_video_tpu_torch.serving.worker import serve_worker  # noqa: E402

FRAMES, HW, STEPS = 8, 64, 30
# the servers start with the first worker run, so the thread runs go first
ORDER = ("main", "main", "thread", "thread", "worker", "worker")


class TimedGraph(torch.cuda.graph):
    """``torch.cuda.graph`` with the seconds of its entry, its body (the
    recording) and its exit (``capture_end`` and the instantiation)."""
    spans = []

    def __enter__(self):
        t0 = time.perf_counter()
        super().__enter__()
        self._marks = (t0, time.perf_counter())

    def __exit__(self, *args):
        t2 = time.perf_counter()
        out = super().__exit__(*args)
        t0, t1 = self._marks
        TimedGraph.spans.append(dict(enter_s=t1 - t0, record_s=t2 - t1,
                                     exit_s=time.perf_counter() - t2))
        return out


class PipelinePredictor:
    """What the worker's job thread calls: ``job()`` a job."""

    def __init__(self, job):
        self.job = job

    def predict(self, **kwargs):
        self.job()
        return "done"


def post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_capture_threads: no CUDA device", file=sys.stderr)
        return 2
    for var in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY", "all_proxy",
                "ALL_PROXY"):
        os.environ.pop(var, None)  # the servers are local
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = load_pipeline(None, decode_dtype=torch.bfloat16, random_init=True, device="cuda")
    clip = torch.rand((1, FRAMES, HW, HW, 3), generator=torch.Generator(device="cuda").manual_seed(
        31), device="cuda") * 2 - 1

    def run():
        pipe("a video", clip, num_inference_steps=STEPS, guidance_scale=6.0, noise_level=150,
             negative_prompt="blur, worst quality",
             generator=torch.Generator(device="cuda").manual_seed(7))

    run()  # the kernels built and loaded, the lazy state of the main thread filled
    torch.cuda.synchronize()
    records = []

    def pair():
        """The key's first call (eager), then its second (capture, replay),
        on the calling thread; the record of the capture."""
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        eager = time.perf_counter() - t0
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        call = time.perf_counter() - t0
        loop = pipe.graphs.loop
        if loop is None:
            raise RuntimeError("the second call did not capture")
        records.append(dict(eager_call_s=eager, capturing_call_s=call, capture_s=loop.capture_s,
                            threads=threading.active_count(), **TimedGraph.spans[-1]))

    servers = []

    def on_thread():
        t = threading.Thread(target=pair)
        t.start()
        t.join()

    def on_worker():
        if not servers:  # the servers start at the first worker run
            servers.append(serve_controller("127.0.0.1", 0))
            threading.Thread(target=servers[0].serve_forever, daemon=True).start()
            servers.append(serve_worker("c7", "127.0.0.1", 0,
                                        f"http://127.0.0.1:{servers[0].server_address[1]}",
                                        PipelinePredictor(pair)))
            threading.Thread(target=servers[1].serve_forever, daemon=True).start()
        reply = post(f"http://127.0.0.1:{servers[1].server_address[1]}/predict", {})
        if reply.get("output") != "done":
            raise RuntimeError(f"the worker's job failed: {reply}")

    where = {"main": pair, "thread": on_thread, "worker": on_worker}
    plain_graph = torch.cuda.graph
    torch.cuda.graph = TimedGraph
    try:
        for kind in ORDER:
            pipe.graphs.clear()
            done = len(records)
            where[kind]()
            if len(records) != done + 1:
                raise RuntimeError(f"no capture recorded on the {kind} thread")
            records[-1]["kind"] = kind
            print(json.dumps(records[-1]), flush=True)
    finally:
        torch.cuda.graph = plain_graph
        if servers:
            servers[1].worker.stop()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "capture_threads.json"), "w") as f:
        json.dump({"card": card, "records": records}, f, indent=1)
    for kind in ("main", "thread", "worker"):
        got = [r for r in records if r["kind"] == kind]
        print(f"{kind}: capture " + ", ".join(
            f"{r['capture_s']:.2f} s (recording {r['record_s']:.2f}, exit {r['exit_s']:.2f})"
            for r in got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
