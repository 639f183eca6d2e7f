"""Model worker: registers with the controller, heartbeats, and runs upscale
jobs one at a time on its card.

Port of ``upscale_a_video_tpu/serving/worker.py`` (the reference LLaVA
serving's model worker, rebuilt for the upscaler; the streamed reply follows
its ``generate_stream`` chunked protocol):

    POST /predict {video_path, ...predict kwargs}           → {output}
    POST /predict {..., "stream": true} → chunked NDJSON: one
         {"progress": {stage, i, n}} line per tick of the predictor, then
         {"output": ...} (or {"error": ...}) as the last line
    POST /status → {queue_length}

Every CUDA call of a job runs on the worker's one job thread: the HTTP
handler threads pass Python objects to it and back, and never touch the
card. So the job thread alone fills the pipeline's lazy state (kernel
operands, the library handles of its streams) and captures the denoise loop
as a CUDA graph (``step_mode="scan"``) while other requests are received.

    python -m upscale_a_video_tpu_torch.serving.worker --device cuda --random_weights \\
        --controller http://localhost:21001 --port 21002
"""

from __future__ import annotations

import inspect
import json
import queue
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .controller import WORKER_HEART_BEAT_INTERVAL
from .predictor import Predictor


class Worker:
    def __init__(self, name: str, url: str, controller_url: str, predictor: Predictor):
        self.name = name
        self.url = url
        self.controller_url = controller_url
        self.predictor = predictor
        self.jobs: "queue.Queue[tuple]" = queue.Queue()
        self._stop = threading.Event()
        # progress_cb goes only to a predictor that takes it
        self._supports_progress = "progress_cb" in inspect.signature(predictor.predict).parameters

    # --------------------------------------------------- controller protocol

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(self.controller_url + path,
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())

    def register(self) -> None:
        self._post("/register_worker", {"name": self.name, "url": self.url})

    def heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                r = self._post("/heartbeat", {"name": self.name,
                                              "queue_length": self.jobs.qsize()})
                if not r.get("exist"):
                    self.register()  # the controller restarted
            except Exception:  # noqa: BLE001  a controller that is down is retried next beat
                pass
            self._stop.wait(WORKER_HEART_BEAT_INTERVAL)

    # ------------------------------------------------------------- job loop

    def job_loop(self) -> None:
        while not self._stop.is_set():
            try:
                kwargs, result_box, done, events = self.jobs.get(timeout=1.0)
            except queue.Empty:
                continue
            if events is not None and self._supports_progress:
                def cb(stage, i, n, _ev=events):
                    _ev.put({"progress": {"stage": stage, "i": i, "n": n}})
                kwargs = dict(kwargs, progress_cb=cb)
            try:
                result_box["output"] = self.predictor.predict(**kwargs)
            except Exception as e:  # noqa: BLE001  a failed job does not stop the worker
                result_box["error"] = f"{type(e).__name__}: {e}"
            if events is not None:
                events.put(dict(result_box))
                events.put(None)  # the end of the stream
            done.set()

    def submit(self, kwargs: dict, timeout: float = 3600.0) -> dict:
        """Queue a job and wait for its result."""
        box: dict = {}
        done = threading.Event()
        self.jobs.put((kwargs, box, done, None))
        done.wait(timeout)
        return box

    def submit_stream(self, kwargs: dict) -> "queue.Queue":
        """Queue a job; the returned queue yields {"progress": ...} events,
        then the result, then None."""
        events: "queue.Queue" = queue.Queue()
        self.jobs.put((kwargs, {}, threading.Event(), events))
        return events

    def start(self) -> None:
        try:
            self.register()
        except Exception:  # noqa: BLE001  the heartbeat loop registers once the controller is up
            pass
        threading.Thread(target=self.heartbeat_loop, daemon=True).start()
        threading.Thread(target=self.job_loop, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()


def make_handler(worker: Worker):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked replies need 1.1

        def log_message(self, *args):
            pass

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        def _stream_predict(self, data: dict):
            events = worker.submit_stream(data)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            while (ev := events.get()) is not None:
                try:
                    self._chunk(json.dumps(ev).encode() + b"\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return  # the client went away; the job still completes
            self.wfile.write(b"0\r\n\r\n")

        def do_POST(self):  # noqa: N802 (the standard library's name)
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(data, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as e:  # json.JSONDecodeError is one
                self._json(400, {"error": f"bad request body: {e}"})
                return
            if self.path == "/predict":
                if data.pop("stream", False):
                    self._stream_predict(data)
                    return
                result = worker.submit(data)
                self._json(200 if "output" in result else 500, result)
            elif self.path == "/status":
                self._json(200, {"queue_length": worker.jobs.qsize()})
            else:
                self._json(404, {"error": "unknown endpoint"})

    return Handler


def serve_worker(name: str, host: str, port: int, controller_url: str,
                 predictor: Predictor) -> ThreadingHTTPServer:
    """A bound server whose worker has registered (or will, by heartbeat)
    under the bound port (``port`` 0 picks a free one); the caller runs
    ``serve_forever``. ``server.worker`` is the worker."""
    worker = Worker(name, "", controller_url, predictor)
    server = ThreadingHTTPServer((host, port), make_handler(worker))
    worker.url = f"http://{host}:{server.server_address[1]}"
    worker.start()
    server.worker = worker  # type: ignore[attr-defined]
    return server


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--name", default="worker-0")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--controller", default="http://localhost:21001")
    ap.add_argument("--model_dir", default="./pretrained_models/upscale_a_video")
    ap.add_argument("--random_weights", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    predictor = Predictor()
    predictor.setup(args.model_dir, random_weights=args.random_weights, device=args.device)
    srv = serve_worker(args.name, args.host, args.port, args.controller, predictor)
    print(f"worker {args.name} on {args.host}:{args.port}", flush=True)
    srv.serve_forever()
