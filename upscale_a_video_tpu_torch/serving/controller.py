"""HTTP controller of the serving stack: a registry of workers with
heartbeat expiry, and dispatch to the worker with the shortest queue
(``"shortest_queue"``) or by a speed-weighted lottery (``"lottery"``).

Copy of ``upscale_a_video_tpu/serving/controller.py`` (itself the reference
LLaVA serving's controller, rebuilt for the upscaler), standard library
only. Protocol, JSON over HTTP:

    POST /register_worker   {name, url, speed}
    POST /heartbeat         {name, queue_length}   → {ok, exist}
    POST /list_workers                             → {name: {url, queue_length, speed}}
    POST /get_worker        {}                     → {url} | 404

    python -m upscale_a_video_tpu_torch.serving.controller --port 21001
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

CONTROLLER_HEART_BEAT_EXPIRATION = 30  # seconds (ref llava/constants.py:1)
WORKER_HEART_BEAT_INTERVAL = 15        # seconds (ref llava/constants.py:2)


@dataclass
class WorkerInfo:
    url: str
    speed: float = 1.0
    queue_length: int = 0
    last_heartbeat: float = field(default_factory=time.time)


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        if dispatch_method not in ("shortest_queue", "lottery"):
            raise ValueError(f"dispatch method {dispatch_method!r}: shortest_queue or lottery")
        self.dispatch_method = dispatch_method
        self.workers: Dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()

    def register_worker(self, name: str, url: str, speed: float = 1.0) -> None:
        with self.lock:
            self.workers[name] = WorkerInfo(url=url, speed=speed)

    def heartbeat(self, name: str, queue_length: int) -> bool:
        """False for a worker the registry does not hold (it re-registers)."""
        with self.lock:
            if name not in self.workers:
                return False
            w = self.workers[name]
            w.queue_length = queue_length
            w.last_heartbeat = time.time()
            return True

    def remove_stale_workers(self) -> None:
        now = time.time()
        with self.lock:
            for n in [n for n, w in self.workers.items()
                      if now - w.last_heartbeat > CONTROLLER_HEART_BEAT_EXPIRATION]:
                del self.workers[n]

    def get_worker(self) -> Optional[str]:
        """The URL of the worker to send a job to, or None without workers.
        Shortest queue counts the job it hands out against that worker."""
        self.remove_stale_workers()
        with self.lock:
            if not self.workers:
                return None
            if self.dispatch_method == "shortest_queue":
                name = min(self.workers, key=lambda n: self.workers[n].queue_length
                           / max(self.workers[n].speed, 1e-6))
                self.workers[name].queue_length += 1
                return self.workers[name].url
            names = list(self.workers)
            speeds = np.array([self.workers[n].speed for n in names], dtype=np.float64)
            return self.workers[np.random.choice(names, p=speeds / speeds.sum())].url


class Handler(BaseHTTPRequestHandler):
    """The controller's endpoints; the registry is the server's
    ``controller`` (a class per server would keep it in a reference cycle)."""

    def log_message(self, *args):
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802 (the standard library's name)
        n = int(self.headers.get("Content-Length", 0))
        data = json.loads(self.rfile.read(n) or b"{}")
        controller = self.server.controller
        if self.path == "/register_worker":
            controller.register_worker(data["name"], data["url"],
                                       float(data.get("speed", 1.0)))
            self._json(200, {"ok": True})
        elif self.path == "/heartbeat":
            ok = controller.heartbeat(data["name"], int(data.get("queue_length", 0)))
            self._json(200 if ok else 404, {"ok": ok, "exist": ok})
        elif self.path == "/list_workers":
            controller.remove_stale_workers()
            with controller.lock:
                listing = {n: {"url": w.url, "queue_length": w.queue_length,
                               "speed": w.speed} for n, w in controller.workers.items()}
            self._json(200, listing)
        elif self.path == "/get_worker":
            url = controller.get_worker()
            if url is None:
                self._json(404, {"error": "no workers"})
            else:
                self._json(200, {"url": url})
        else:
            self._json(404, {"error": "unknown endpoint"})


def serve_controller(host: str = "0.0.0.0", port: int = 21001,
                     dispatch_method: str = "shortest_queue") -> ThreadingHTTPServer:
    """A bound server (``port`` 0 picks a free port); the caller runs
    ``serve_forever``. ``server.controller`` is its registry."""
    controller = Controller(dispatch_method)
    server = ThreadingHTTPServer((host, port), Handler)
    server.controller = controller  # type: ignore[attr-defined]
    return server


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21001)
    ap.add_argument("--dispatch-method", default="shortest_queue")
    args = ap.parse_args()
    srv = serve_controller(args.host, args.port, args.dispatch_method)
    print(f"controller on {args.host}:{args.port}", flush=True)
    srv.serve_forever()
