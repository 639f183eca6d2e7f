"""The port's serving stack on the CPU, without a model: the controller
(registry, dispatch, heartbeat expiry, speed weighting; the port's and the
JAX package's ``Controller`` held to the same answers), the worker's
registration, job loop and chunked-NDJSON stream with a stand-in predictor,
the web demo (page, round trip, no workers, paths outside the work
directory, malformed JSON, the streamed upscale through a real worker, the
forwarded seed and segment length), and the caption worker's PNG protocol
against the port's ``EndpointCaptioner`` (a stand-in captioner). Every
server binds 127.0.0.1 on a free port; the proxy variables are cleared so
that urllib talks to it directly."""

import base64
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from upscale_a_video_tpu.serving.controller import Controller as JController
from upscale_a_video_tpu_torch.captioner import EndpointCaptioner
from upscale_a_video_tpu_torch.serving import caption_worker
from upscale_a_video_tpu_torch.serving.controller import Controller, serve_controller
from upscale_a_video_tpu_torch.serving.web_demo import serve_web_demo
from upscale_a_video_tpu_torch.serving.worker import Worker, serve_worker


@pytest.fixture(autouse=True)
def no_proxy(monkeypatch):
    for var in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY", "all_proxy",
                "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")


def serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def post(url, payload, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def ndjson(url, payload, timeout=15):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in resp if line.strip()]


# ------------------------------------------------------------------ controller

@pytest.mark.parametrize("cls", [Controller, JController], ids=["port", "jax"])
class TestController:
    def test_register_and_dispatch(self, cls):
        c = cls()
        c.register_worker("a", "http://a", 1.0)
        c.register_worker("b", "http://b", 1.0)
        c.workers["a"].queue_length, c.workers["b"].queue_length = 5, 1
        assert c.get_worker() == "http://b"
        assert c.workers["b"].queue_length == 2  # the dispatched job counts

    def test_heartbeat_expiry(self, cls):
        c = cls()
        c.register_worker("a", "http://a")
        c.workers["a"].last_heartbeat = time.time() - 100
        assert c.get_worker() is None and "a" not in c.workers

    def test_heartbeat_unknown_worker(self, cls):
        c = cls()
        assert not c.heartbeat("ghost", 0)
        c.register_worker("a", "http://a")
        assert c.heartbeat("a", 3) and c.workers["a"].queue_length == 3

    def test_speed_weighting(self, cls):
        c = cls()
        c.register_worker("slow", "http://slow", speed=1.0)
        c.register_worker("fast", "http://fast", speed=10.0)
        c.workers["slow"].queue_length, c.workers["fast"].queue_length = 2, 10
        assert c.get_worker() == "http://fast"  # 10 / 10 < 2 / 1

    def test_lottery_follows_speed(self, cls):
        c = cls("lottery")
        c.register_worker("only", "http://only", speed=2.0)
        np.random.seed(0)
        assert {c.get_worker() for _ in range(5)} == {"http://only"}


def test_unknown_dispatch_method_raises():
    with pytest.raises(ValueError, match="dispatch method"):
        Controller("round_robin")


# ------------------------------------------------------------------ worker

class FakePredictor:
    def predict(self, **kwargs):
        return f"done:{kwargs.get('video_path')}"


class ProgressPredictor:
    """Takes ``progress_cb``, so the worker streams its ticks."""

    def predict(self, video_path=None, progress_cb=None, **kwargs):
        if progress_cb is not None:
            for i in range(1, 4):
                progress_cb("denoise", i, 3)
            progress_cb("decode", 1, 1)
        return f"done:{video_path}"


class FailingPredictor:
    def predict(self, **kwargs):
        raise RuntimeError("out of memory")


@pytest.fixture()
def controller():
    srv = serve_controller("127.0.0.1", 0)
    url = serve(srv)
    yield srv, url
    srv.shutdown()


def test_worker_registers_and_is_dispatched(controller):
    _, url = controller
    Worker("w0", "http://127.0.0.1:9999", url, FakePredictor()).register()
    code, workers = post(url + "/list_workers", {})
    assert code == 200 and workers["w0"]["url"] == "http://127.0.0.1:9999"
    assert post(url + "/get_worker", {})[1] == {"url": "http://127.0.0.1:9999"}


def test_worker_runs_jobs_and_survives_a_failed_one(controller):
    _, url = controller
    worker = Worker("w1", "http://127.0.0.1:9998", url, FakePredictor())
    worker.start()
    try:
        assert worker.submit({"video_path": "clip.mp4"}, timeout=10) == {
            "output": "done:clip.mp4"}
    finally:
        worker.stop()
    worker = Worker("w2", "http://127.0.0.1:9997", url, FailingPredictor())
    worker.start()
    try:
        assert worker.submit({}, timeout=10) == {"error": "RuntimeError: out of memory"}
    finally:
        worker.stop()


@pytest.mark.parametrize("predictor,progress", [(ProgressPredictor(), True),
                                                (FakePredictor(), False)])
def test_worker_streams_ndjson(controller, predictor, progress):
    """Progress lines (when the predictor takes ``progress_cb``), then the
    result as the last line; /status reports the queue."""
    _, url = controller
    wsrv = serve_worker("w-s", "127.0.0.1", 0, url, predictor)
    wurl = serve(wsrv)
    try:
        events = ndjson(wurl + "/predict", {"video_path": "c.mp4", "stream": True})
        want = [{"stage": "denoise", "i": i, "n": 3} for i in (1, 2, 3)] + [
            {"stage": "decode", "i": 1, "n": 1}]
        assert [e["progress"] for e in events if "progress" in e] == (want if progress else [])
        assert events[-1] == {"output": "done:c.mp4"}
        assert post(wurl + "/status", {}) == (200, {"queue_length": 0})
        assert post(url + "/list_workers", {})[1]["w-s"]["url"] == wurl
    finally:
        wsrv.worker.stop()
        wsrv.shutdown()


# ------------------------------------------------------------------ web demo

class StubWorkerHandler(BaseHTTPRequestHandler):
    """A worker stand-in: /predict writes a small file recording its request."""

    def log_message(self, *args):
        pass

    def do_POST(self):  # noqa: N802
        data = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}")
        os.makedirs(data["output_path"], exist_ok=True)
        out = os.path.join(data["output_path"], "result.mp4")
        with open(out, "wb") as f:
            f.write(b"FAKEMP4" + json.dumps(data, sort_keys=True).encode())
        body = json.dumps({"output": out}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture()
def stack(tmp_path):
    ctrl = serve_controller("127.0.0.1", 0)
    worker = ThreadingHTTPServer(("127.0.0.1", 0), StubWorkerHandler)
    demo = serve_web_demo("127.0.0.1", 0, serve(ctrl), work_dir=str(tmp_path / "work"))
    ctrl.controller.register_worker("w0", serve(worker))
    yield serve(demo), demo
    for s in (ctrl, worker, demo):
        s.shutdown()


def test_page_and_model_list(stack):
    demo_url, _ = stack
    with urllib.request.urlopen(demo_url + "/", timeout=10) as resp:
        page = resp.read().decode()
    assert "Upscale-A-Video" in page and "noise" in page.lower()
    code, models = post(demo_url + "/list_models", {})
    assert code == 200 and "w0" in models


def test_upscale_round_trip_and_file_serving(stack, tmp_path):
    demo_url, demo = stack
    code, result = post(demo_url + "/upscale", {
        "video_b64": base64.b64encode(b"INPUTVIDEO").decode(), "filename": "clip.mp4",
        "noise_level": 120, "guidance_scale": 9, "inference_steps": 5,
        "propagation_steps": "2,4", "color_fix": "AdaIn", "seed": 7, "segment_frames": 8})
    assert code == 200 and "output" in result and "job_id" in result
    with open(result["output"], "rb") as f:
        recorded = json.loads(f.read()[7:])
    assert (recorded["noise_level"], recorded["propagation_steps"], recorded["color_fix"],
            recorded["seed"], recorded["segment_frames"]) == (120, [2, 4], "AdaIn", 7, 8)
    assert "tile_size" not in recorded  # not forwarded: the predictor's default
    with open(recorded["video_path"], "rb") as f:  # the upload, in the work directory
        assert f.read() == b"INPUTVIDEO"
    q = urllib.parse.quote(result["output"])
    with urllib.request.urlopen(f"{demo_url}/file?path={q}", timeout=10) as r:
        assert r.read().startswith(b"FAKEMP4")
    outside = tmp_path / "secret.txt"
    outside.write_text("x")
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"{demo_url}/file?path={urllib.parse.quote(str(outside))}",
                               timeout=10)
    assert [p for p in os.listdir(demo.demo.log_dir) if p.endswith(".jsonl")]
    with urllib.request.urlopen(demo_url + "/jobs", timeout=10) as r:
        jobs = json.loads(r.read())["jobs"]
    assert [j["status"] for j in jobs if j["id"] == result["job_id"]] == ["done"]


def test_upscale_errors_without_workers(tmp_path):
    ctrl = serve_controller("127.0.0.1", 0)
    demo = serve_web_demo("127.0.0.1", 0, serve(ctrl), work_dir=str(tmp_path / "w"))
    demo_url = serve(demo)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(demo_url + "/upscale", {"video_b64": base64.b64encode(b"x").decode()})
        assert ei.value.code == 500
        assert json.loads(ei.value.read())["error"] == "no workers available"
    finally:
        ctrl.shutdown()
        demo.shutdown()


def test_upscale_refuses_paths_outside_the_work_dir(stack, tmp_path):
    demo_url, _ = stack
    outside = tmp_path / "private.mp4"
    outside.write_bytes(b"SECRET")
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(demo_url + "/upscale", {"video_path": str(outside)})
    assert ei.value.code == 500 and "work dir" in json.loads(ei.value.read())["error"]


def test_malformed_json_returns_400(stack):
    demo_url, _ = stack
    req = urllib.request.Request(demo_url + "/upscale", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400 and "bad request body" in json.loads(ei.value.read())["error"]


def test_streamed_upscale_through_a_real_worker(tmp_path):
    """The demo forwards the worker's progress lines and ends with the
    result; the job registry holds the last tick and the final state."""

    class StreamingPredictor:
        def predict(self, video_path=None, output_path=None, progress_cb=None, **kwargs):
            os.makedirs(output_path, exist_ok=True)
            out = os.path.join(output_path, "result.mp4")
            with open(out, "wb") as f:
                f.write(b"FAKEMP4")
            for tick in (("denoise", 1, 2), ("denoise", 2, 2), ("decode", 1, 1)):
                progress_cb(*tick)
            return out

    ctrl = serve_controller("127.0.0.1", 0)
    ctrl_url = serve(ctrl)
    wsrv = serve_worker("w-s", "127.0.0.1", 0, ctrl_url, StreamingPredictor())
    serve(wsrv)
    demo = serve_web_demo("127.0.0.1", 0, ctrl_url, work_dir=str(tmp_path / "work"))
    demo_url = serve(demo)
    try:
        events = ndjson(demo_url + "/upscale", {
            "stream": True, "video_b64": base64.b64encode(b"VID").decode(),
            "filename": "c.mp4", "inference_steps": 2})
        assert [e["progress"] for e in events if "progress" in e] == [
            {"stage": "denoise", "i": 1, "n": 2}, {"stage": "denoise", "i": 2, "n": 2},
            {"stage": "decode", "i": 1, "n": 1}]
        assert "job_id" in events[0] and "output" in events[-1]
        with urllib.request.urlopen(demo_url + "/jobs", timeout=10) as r:
            mine = [j for j in json.loads(r.read())["jobs"] if j["id"] == events[-1]["job_id"]]
        assert mine[0]["status"] == "done"
        assert mine[0]["progress"] == {"stage": "decode", "i": 1, "n": 1}
    finally:
        wsrv.worker.stop()
        for s in (ctrl, wsrv, demo):
            s.shutdown()


# ------------------------------------------------------------------ caption worker

class FakeCaptioner:
    def __init__(self):
        self.seen = None

    def caption(self, frame):
        self.seen = frame
        return f"a video frame of shape {frame.shape[0]}x{frame.shape[1]}"


@pytest.fixture()
def caption_server():
    cap = FakeCaptioner()
    srv = caption_worker.serve(cap, port=0, host="127.0.0.1")
    yield cap, serve(srv)
    srv.shutdown()


def test_caption_round_trip(caption_server):
    """The port's endpoint client resizes the short side to 512 and sends a
    PNG; the worker decodes it exactly and answers with the caption."""
    cap, url = caption_server
    frame = np.random.default_rng(0).integers(0, 255, (600, 800, 3), dtype=np.uint8)
    text = EndpointCaptioner(url)(frame)
    assert cap.seen.shape == (512, 683, 3) and cap.seen.dtype == np.uint8
    assert text == "a video frame of shape 512x683"


def test_caption_health_and_errors(caption_server):
    _, url = caption_server
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.read() == b"ok"
    req = urllib.request.Request(url, data=b"not a png", headers={"Content-Type": "image/png"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 500 and ei.value.read().startswith(b"caption error")
