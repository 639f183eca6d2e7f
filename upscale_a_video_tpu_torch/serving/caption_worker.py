"""Caption worker: an HTTP service that hosts the port's LLaVA captioner on
its own card, as the port's ``captioner.EndpointCaptioner`` (the
``UAV_CAPTION_ENDPOINT`` backend) expects it.

Port of ``upscale_a_video_tpu/serving/caption_worker.py``. The client sends
the frame as a PNG with the question in a header, and gets the caption
back as text:

    POST /  (Content-Type: image/png, X-Question: <prompt>) → text/plain
    GET  /  → "ok" (health)

Captions run one at a time (the reference's worker is serial too); the
question header is read by no backend: the captioner asks its own.

    python -m upscale_a_video_tpu_torch.serving.caption_worker \\
        --model_dir /path/to/llava-v1.5 --port 21005 [--load_8bit] [--device cuda]
"""

from __future__ import annotations

import argparse
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..captioner import CAPTION_QUESTION
from ..utils import video_io


def make_handler(captioner, lock: threading.Lock):
    """``captioner.caption(frame_u8) -> str`` behind the protocol above."""
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802 (the standard library's name)
            try:
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                frame = video_io.decode_png(body)
                with lock:
                    text = captioner.caption(frame)
                self._reply(200, text.encode(), "text/plain; charset=utf-8")
            except Exception as e:  # noqa: BLE001  the client gets the error as the reply
                self._reply(500, f"caption error: {e}".encode(), "text/plain; charset=utf-8")

        def do_GET(self):  # noqa: N802
            self._reply(200, b"ok", "text/plain")

        def log_message(self, *args):
            pass

    return Handler


def serve(captioner, port: int = 21005, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """A bound server (``port`` 0 picks a free one); the caller runs
    ``serve_forever``."""
    return ThreadingHTTPServer((host, port), make_handler(captioner, threading.Lock()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--base_dir", default=None, help="the base LLaMA of a delta checkpoint")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21005)
    ap.add_argument("--load_8bit", action="store_true",
                    help="int8 storage of the large weights (utils/quant.py)")
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..models.llava.loader import load_llava_captioner

    cap = load_llava_captioner(args.model_dir, base_dir=args.base_dir,
                               max_new_tokens=args.max_new_tokens, load_8bit=args.load_8bit,
                               device=args.device)
    server = serve(cap, args.port, args.host)
    print(f"caption worker on {args.host}:{args.port} (question: {CAPTION_QUESTION!r})",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
