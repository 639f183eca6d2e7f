"""The port's serving ``Predictor`` against the JAX package's on the same
tiny bundle (``tests/torch_bundle.py``, 3D VAE, float32), 2 steps.

Each side's pipeline is wrapped to receive the same initial latents and LR
noise per call (the ``latents``/``lr_noise`` seams, drawn with numpy from
the call's index), and both packages' video IO is replaced by in-memory
stand-ins over the same uint8 frames. The frames each predictor hands to
``from_model_range`` (float, before the uint8 conversion) agree within one
level of 255 in model range (2 / 255: the tolerance of
``test_torch_cli.py::test_process_clip_matches_the_jax_steps``; 8.5e-6 to
5.3e-5 measured), and the
progress ticks (``denoise``, ``decode``, ``tile``, ``segment``) are equal,
for a plain clip, a clip that needs tiling (two tiles, one a call) and the
segmented stream through the native ring (two segments, seeds ``seed`` and
``seed + 1``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bundle import write_bundle
from upscale_a_video_tpu.pipeline import tiling as j_tiling
from upscale_a_video_tpu.pipeline.loader import load_pipeline as jax_load_pipeline
from upscale_a_video_tpu.serving.predictor import Predictor as JPredictor
from upscale_a_video_tpu.utils import video_io as j_video_io
from upscale_a_video_tpu_torch.pipeline import load_pipeline
from upscale_a_video_tpu_torch.serving import predictor as t_predictor
from upscale_a_video_tpu_torch.serving.predictor import Predictor
from upscale_a_video_tpu_torch.utils import video_io

torch.set_num_threads(1)
LEVEL = 2 / 255  # one uint8 level in model range


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundle")
    write_bundle(root, video=False)
    return root


@pytest.fixture(scope="module")
def pipelines(bundle):
    """(port, JAX) pipelines in float32, host-stepped (per-step ticks)."""
    tpipe = load_pipeline(str(bundle), dtype=torch.float32, device="cpu")
    tpipe.step_mode = "host"
    jpipe = jax_load_pipeline(str(bundle), dtype=jnp.float32, decode_dtype=jnp.float32)
    jpipe.step_mode = "host"
    return tpipe, jpipe


def noise(call: int, shape):
    """The call's initial latents and LR noise, (B, T, H, W, 4|3)."""
    rng = np.random.default_rng(1000 + call)
    b, t, h, w = shape[:4]
    return (rng.standard_normal((b, t, h, w, 4)).astype(np.float32),
            rng.standard_normal((b, t, h, w, 3)).astype(np.float32))


class SeededCalls:
    """A pipeline whose n-th call gets :func:`noise` ``(n, ...)``; records
    each call's seed (the generator's, or the JAX key's)."""

    def __init__(self, pipe, jax_side: bool):
        self.__dict__.update(pipe=pipe, jax_side=jax_side, seeds=[])

    def __call__(self, prompt, image, *args, **kwargs):
        lat, lr = noise(len(self.seeds), image.shape)
        if self.jax_side:
            self.seeds.append(int(np.asarray(kwargs["key"])[-1]))
            kwargs.update(latents=jnp.asarray(lat), lr_noise=jnp.asarray(lr))
        else:
            self.seeds.append(kwargs["generator"].initial_seed())
            kwargs.update(latents=torch.from_numpy(lat), lr_noise=torch.from_numpy(lr))
        return self.pipe(prompt, image, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.pipe, name)


class Writer:
    """The stand-in of ``VideoWriter``: keeps each appended segment."""

    def __init__(self, path, fps=25.0):
        self.path, self.segments = path, []
        Writer.last = self

    def append(self, frames_u8):
        self.segments.append(frames_u8)

    def close(self):
        pass


def in_memory_io(monkeypatch, module, frames_u8, floats):
    """Replace ``module``'s reading and writing by stand-ins over
    ``frames_u8``; ``floats`` collects what goes to ``from_model_range``."""
    to_u8 = module.from_model_range

    def record(frames):
        floats.append(np.asarray(frames, np.float32))
        return to_u8(frames)

    def stream(path, batch=8):
        for s in range(0, len(frames_u8), batch):
            yield frames_u8[s:s + batch]

    monkeypatch.setattr(module, "read_video", lambda path: (frames_u8, 8.0, "clip"))
    monkeypatch.setattr(module, "write_video", lambda path, frames, fps=25.0, **kw: None)
    monkeypatch.setattr(module, "stream_video", stream)
    monkeypatch.setattr(module, "VideoWriter", Writer)
    monkeypatch.setattr(module, "from_model_range", record)


def run_both(monkeypatch, pipelines, frames_u8, **kwargs):
    """Both predictors on the same request: (port, JAX) records of the
    floats before the uint8 conversion, the ticks and the seeds."""
    tpipe, jpipe = pipelines
    out = []
    for pred, pipe, io, jax_side in ((Predictor(), tpipe, video_io, False),
                                     (JPredictor(), jpipe, j_video_io, True)):
        pred.pipeline, pred.model_dir = SeededCalls(pipe, jax_side), "no-bundle"
        floats, ticks = [], []
        in_memory_io(monkeypatch, io, frames_u8, floats)
        Writer.last = None
        pred.predict("clip.mp4", output_path="out", inference_steps=2, seed=5,
                     progress_cb=lambda *tick: ticks.append(tick), **kwargs)
        out.append(dict(floats=floats, ticks=ticks, seeds=pred.pipeline.seeds,
                        writer=Writer.last))
    return out


def frames(t, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)


def assert_close(port, jax_rec):
    assert len(port["floats"]) == len(jax_rec["floats"])
    for got, want in zip(port["floats"], jax_rec["floats"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= LEVEL


def test_plain_clip_matches_jax(monkeypatch, pipelines):
    port, ref = run_both(monkeypatch, pipelines, frames(4, 8, 8), caption="a cat, ",
                         color_fix="AdaIn")
    assert port["ticks"] == ref["ticks"] == [("denoise", 1, 2), ("denoise", 2, 2),
                                             ("decode", 1, 2), ("decode", 2, 2)]
    assert port["seeds"] == ref["seeds"] == [5]
    assert port["floats"][0].shape == (4, 32, 32, 3)
    assert_close(port, ref)


def test_tiled_clip_matches_jax(monkeypatch, pipelines):
    """A 16x24 clip with the tiling rule forced on and tiles of 8: the plan
    (64 px halo) gives two tiles of the whole frame, pasted into each
    half, one pipeline call each, every call from the same seed."""
    monkeypatch.setattr(t_predictor, "needs_tiling", lambda h, w: True)
    monkeypatch.setattr(j_tiling, "needs_tiling", lambda h, w: True)
    port, ref = run_both(monkeypatch, pipelines, frames(4, 16, 24, seed=1), caption="",
                         tile_size=8)
    per_call = [("denoise", 1, 2), ("denoise", 2, 2), ("decode", 1, 2), ("decode", 2, 2)]
    assert port["ticks"] == ref["ticks"] == (per_call + [("tile", 1, 2)] + per_call
                                             + [("tile", 2, 2)])
    assert port["seeds"] == ref["seeds"] == [5, 5]
    assert port["floats"][0].shape == (4, 64, 96, 3)
    assert_close(port, ref)


def test_segmented_stream_matches_jax(monkeypatch, pipelines):
    """An 8-frame clip in segments of 4 through the native ring: two
    pipeline calls, seeds 5 and 6, each segment appended to the writer."""
    port, ref = run_both(monkeypatch, pipelines, frames(8, 8, 8, seed=2), caption="",
                         segment_frames=4)
    per_call = [("denoise", 1, 2), ("denoise", 2, 2), ("decode", 1, 2), ("decode", 2, 2)]
    assert port["ticks"] == ref["ticks"] == (per_call + [("segment", 1, -1)] + per_call
                                             + [("segment", 2, -1)])
    assert port["seeds"] == ref["seeds"] == [5, 6]
    assert [f.shape for f in port["floats"]] == [(4, 32, 32, 3)] * 2
    assert [s.shape for s in port["writer"].segments] == [(4, 32, 32, 3)] * 2
    assert_close(port, ref)


def test_stream_flushes_every_full_segment(monkeypatch, pipelines):
    """Segments of 3 from one 8-frame batch: 3, 3, then the last 2 (the
    port flushes every full segment as soon as it has it)."""
    tpipe, _ = pipelines
    pred = Predictor()
    pred.pipeline = SeededCalls(tpipe, False)
    floats = []
    in_memory_io(monkeypatch, video_io, frames(8, 8, 8, seed=3), floats)
    pred.predict("clip.mp4", inference_steps=1, seed=0, segment_frames=3)
    assert [f.shape[0] for f in floats] == [3, 3, 2]
    assert pred.pipeline.seeds == [0, 1, 2]


def test_setup_loads_a_bf16_decode_on_the_named_device(bundle, monkeypatch):
    for var in ("UAV_CAPTION_TORCH_MODEL", "UAV_CAPTION_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)
    pred = Predictor()
    pred.setup(str(bundle), device="cpu")
    assert pred.pipeline.device.type == "cpu" and pred.captioner is None
    assert pred.pipeline.m.vae.post_quant_conv.weight.dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor().setup(str(bundle))
    with pytest.raises(RuntimeError, match="setup"):
        Predictor().predict("clip.mp4")
