"""Fault C8 (ROADMAP C): the port must free its models by reference
counting alone. Device memory held in a reference cycle is freed only when
the cyclic collector happens to run, so a serving worker that keeps a
pipeline across requests, or a script that drops one, would hold it on the
card until then. Each test runs with ``gc`` disabled and asserts through a
``weakref`` that the UNet is gone once the last reference to what holds it
is dropped: a tiny pipeline after a call, a ``Predictor`` after a call, and
a ``Predictor`` served by a worker (its HTTP server and threads stopped)
after a job."""

import gc
import json
import os
import threading
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from torch_bundle import write_bundle
from upscale_a_video_tpu_torch.pipeline import load_pipeline
from upscale_a_video_tpu_torch.serving import predictor as predictor_module
from upscale_a_video_tpu_torch.serving.controller import serve_controller
from upscale_a_video_tpu_torch.serving.predictor import Predictor
from upscale_a_video_tpu_torch.serving.web_demo import serve_web_demo
from upscale_a_video_tpu_torch.serving.worker import serve_worker

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundle")
    write_bundle(root, video=False)
    return str(root)


@pytest.fixture
def no_gc():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@pytest.fixture(autouse=True)
def no_proxy(monkeypatch):
    for var in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY", "all_proxy",
                "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")


def clip():
    return np.random.default_rng(0).integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)


def memory_io(monkeypatch, written):
    """``video_io``'s codec calls on uint8 arrays kept in memory."""
    monkeypatch.setattr(predictor_module.video_io, "read_video",
                        lambda path: (clip(), 25.0, "clip"))
    monkeypatch.setattr(predictor_module.video_io, "write_video",
                        lambda path, frames, fps=25.0: written.append(frames))


def test_pipeline_is_freed_by_refcount(bundle, no_gc):
    pipe = load_pipeline(bundle, device="cpu")
    unet = weakref.ref(pipe.m.unet)
    out = pipe("a cat", torch.rand(1, 3, 8, 8, 3) * 2 - 1, num_inference_steps=2)
    assert out.shape == (1, 3, 32, 32, 3)
    del pipe
    assert unet() is None


def test_predictor_is_freed_by_refcount(bundle, no_gc, monkeypatch, tmp_path):
    written = []
    memory_io(monkeypatch, written)
    pred = Predictor()
    pred.setup(bundle, with_captioner=False, device="cpu")
    unet = weakref.ref(pred.pipeline.m.unet)
    pred.predict("clip.mp4", str(tmp_path), inference_steps=2, seed=1)
    assert written[0].shape == (3, 32, 32, 3)
    del pred
    assert unet() is None


def test_served_predictor_is_freed_by_refcount(bundle, no_gc, monkeypatch, tmp_path):
    """The controller, a worker holding the Predictor and the web demo on
    127.0.0.1, one job through the demo; then every server shut down and
    the worker stopped."""
    written = []
    memory_io(monkeypatch, written)
    pred = Predictor()
    pred.setup(bundle, with_captioner=False, device="cpu")
    unet = weakref.ref(pred.pipeline.m.unet)
    servers = [serve_controller("127.0.0.1", 0)]
    ctrl_url = f"http://127.0.0.1:{servers[0].server_address[1]}"
    threading.Thread(target=servers[0].serve_forever, daemon=True).start()
    servers.append(serve_worker("w", "127.0.0.1", 0, ctrl_url, pred))
    servers.append(serve_web_demo("127.0.0.1", 0, ctrl_url, work_dir=str(tmp_path)))
    for srv in servers[1:]:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    demo_url = f"http://127.0.0.1:{servers[2].server_address[1]}"
    (tmp_path / "clip.mp4").write_bytes(b"")  # read through the stand-in reader
    req = urllib.request.Request(
        demo_url + "/upscale", headers={"Content-Type": "application/json"},
        data=json.dumps({"video_path": os.path.join(str(tmp_path), "clip.mp4"),
                         "inference_steps": 2, "seed": 1}).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert "output" in json.loads(resp.read())
    assert written[0].shape == (3, 32, 32, 3)
    servers[1].worker.stop()
    for srv in servers:
        srv.shutdown()
        srv.server_close()
    del pred, servers, srv
    assert unet() is None
