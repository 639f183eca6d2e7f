"""The port's eval harness on the CPU, against the JAX package's.

- ``utils/metrics.py``: PSNR and SSIM on the same seeded arrays (with a
  leading batch of clips) within 1e-5, the feature-map ``lpips`` wrapper
  within 1e-6, and the JAX tests' sanity values.
- ``utils/lpips.py``: AlexNet and VGG16 LPIPS from one random state in the
  ``lpips`` package's layout, saved with ``torch.save``: the port loads the
  file by its own key names, the JAX package converts the same file
  (``convert_lpips_state``); distances within 1e-5 relative.
- ``pipeline/eval.py``: ``evaluate_directory`` over two tiny clips with
  ground truth and an LPIPS checkpoint, on the tiny bundle's pipelines
  (``tests/torch_bundle.py``, float32, 2 steps) with the same initial latents
  and LR noise per call on both sides: the same report lines, per-clip
  PSNR within 1e-3 dB, SSIM and LPIPS within 1e-4 of JAX's; a second run
  resumes from the ledger and runs nothing; the aggregates.
"""

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bundle import write_bundle
from upscale_a_video_tpu.pipeline.eval import evaluate_directory as j_evaluate_directory
from upscale_a_video_tpu.pipeline.loader import load_pipeline as jax_load_pipeline
from upscale_a_video_tpu.utils import lpips as j_lpips
from upscale_a_video_tpu.utils import metrics as j_metrics
from upscale_a_video_tpu_torch.pipeline import load_pipeline
from upscale_a_video_tpu_torch.pipeline.eval import evaluate_directory
from upscale_a_video_tpu_torch.utils import metrics, video_io
from upscale_a_video_tpu_torch.utils.checkpoint import ClipLedger
from upscale_a_video_tpu_torch.utils.lpips import LPIPS, load_lpips

torch.set_num_threads(1)


def pair(seed, shape, noise=0.2):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    return a, np.clip(a + noise * rng.standard_normal(shape), -1, 1).astype(np.float32)


# ------------------------------------------------------------------ metrics

@pytest.mark.parametrize("shape", [(3, 16, 16, 3), (2, 2, 24, 20, 3)])
def test_psnr_and_ssim_match_jax(shape):
    a, b = pair(0, shape)
    for name in ("psnr", "ssim"):
        got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(getattr(j_metrics, name)(jnp.asarray(a), jnp.asarray(b)))
        assert got.shape == want.shape == shape[:-3]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_metric_sanity_values():
    a = torch.zeros((1, 8, 8, 1))
    assert abs(float(metrics.psnr(a, torch.full((1, 8, 8, 1), 0.2))[0]) - 20.0) < 1e-4
    x = torch.from_numpy(pair(1, (1, 32, 32, 3))[0])
    assert float(metrics.psnr(x, x)[0]) > 100
    assert abs(float(metrics.ssim(x, x)[0]) - 1.0) < 1e-5
    y = x + 0.3 * torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    z = x + 0.6 * torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    assert float(metrics.ssim(x, z)[0]) < float(metrics.ssim(x, y)[0]) < 0.95


def test_lpips_wrapper_matches_jax():
    a, b = pair(4, (2, 8, 8, 3))
    feats = lambda x: [x, x[:, ::2, ::2] * 2]
    got = metrics.lpips(torch.from_numpy(a), torch.from_numpy(b), feats).numpy()
    want = np.asarray(j_metrics.lpips(jnp.asarray(a), jnp.asarray(b), feats))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="feature extractor"):
        metrics.lpips(torch.from_numpy(a), torch.from_numpy(a))


# ------------------------------------------------------------------ LPIPS

def lpips_state(net: str, seed: int = 0):
    """A random state in the lpips package's layout: PyTorch's initialisers
    for the backbone, non-negative lin weights."""
    torch.manual_seed(seed)
    state = LPIPS(net).state_dict()
    for k in state:
        if k.startswith("lin"):
            state[k] = torch.rand(state[k].shape) * 0.1
    return state


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax_on_the_same_checkpoint(net, tmp_path):
    path = str(tmp_path / f"{net}.pth")
    torch.save(lpips_state(net), path)
    a, b = pair(5, (2, 64, 64, 3), noise=0.3)
    with torch.no_grad():
        got = load_lpips(path, net)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    model, params = j_lpips.load_lpips(path, net)
    want = np.asarray(model.apply(params, jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_load_lpips_reads_the_package_names_and_refuses_a_missing_weight(tmp_path):
    state = lpips_state("alex")
    assert {"net.slice2.3.weight", "net.slice5.10.bias", "lin4.model.1.weight",
            "scaling_layer.shift"} <= set(state)
    del state["scaling_layer.shift"], state["scaling_layer.scale"]  # constants may be absent
    torch.save(state, tmp_path / "ok.pth")
    assert torch.equal(load_lpips(str(tmp_path / "ok.pth")).lin4.model[1].weight,
                       state["lin4.model.1.weight"])
    del state["lin2.model.1.weight"]
    torch.save(state, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="lin2"):
        load_lpips(str(tmp_path / "bad.pth"))


def test_clip_ledger(tmp_path):
    path = str(tmp_path / "d" / "ledger.jsonl")
    led = ClipLedger(path)
    assert not led.is_done("x")
    led.mark_done("x", sec=1.5)
    assert led.is_done("x")
    led2 = ClipLedger(path)  # read back from the file
    assert led2.is_done("x") and led2.pending(["x", "y"]) == ["y"]
    assert json.loads(open(path).read()) == {"clip": "x", "sec": 1.5}


# ------------------------------------------------------------------ evaluate_directory

class NoisedCalls:
    """A pipeline whose n-th call gets the n-th clip's latents and LR noise."""

    def __init__(self, pipe, jax_side):
        self.__dict__.update(pipe=pipe, jax_side=jax_side, calls=0)

    def __call__(self, prompt, video, **kwargs):
        rng = np.random.default_rng(50 + self.calls)
        b, t, h, w = video.shape[:4]
        lat = rng.standard_normal((b, t, h, w, 4)).astype(np.float32)
        lr = rng.standard_normal((b, t, h, w, 3)).astype(np.float32)
        conv = jnp.asarray if self.jax_side else torch.from_numpy
        self.calls += 1
        return self.pipe(prompt, video, latents=conv(lat), lr_noise=conv(lr), **kwargs)

    def __getattr__(self, name):
        return getattr(self.pipe, name)


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    write_bundle(root / "bundle", video=False)
    rng = np.random.default_rng(7)
    for name in ("a", "b"):
        video_io.write_video(str(root / "clips" / f"{name}.mp4"),
                             rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8), fps=8)
        video_io.write_video(str(root / "gt" / f"{name}.mp4"),
                             rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8), fps=8)
    torch.save(lpips_state("alex"), root / "alex.pth")
    return root


def test_evaluate_directory_matches_jax_and_resumes(eval_dirs, tmp_path):
    root = eval_dirs
    kw = dict(gt_dir=str(root / "gt"), num_inference_steps=2, seed=3,
              lpips_ckpt=str(root / "alex.pth"))
    tpipe = NoisedCalls(load_pipeline(str(root / "bundle"), dtype=torch.float32,
                                      device="cpu"), False)
    agg = evaluate_directory(tpipe, str(root / "clips"), str(tmp_path / "t"), **kw)
    jpipe = NoisedCalls(jax_load_pipeline(str(root / "bundle"), dtype=jnp.float32,
                                          decode_dtype=jnp.float32), True)
    j_agg = j_evaluate_directory(jpipe, str(root / "clips"), str(tmp_path / "j"), **kw)

    read = lambda d: [json.loads(x) for x in open(tmp_path / d / "eval_report.jsonl")]
    got, want = read("t"), read("j")
    assert [e["clip"] for e in got] == [e["clip"] for e in want] == ["a", "b"]
    for g, w in zip(got, want):
        assert g["frames"] == w["frames"] == 2
        assert abs(g["psnr"] - w["psnr"]) <= 1e-3
        assert abs(g["ssim"] - w["ssim"]) <= 1e-4 and abs(g["lpips"] - w["lpips"]) <= 1e-4
    assert agg["clips"] == j_agg["clips"] == 2
    assert abs(agg["psnr"] - j_agg["psnr"]) <= 1e-3
    assert agg["psnr"] == round(float(np.mean([e["psnr"] for e in got])), 4)
    assert sorted(os.listdir(tmp_path / "t" / "video")) == ["a.mp4", "b.mp4"]
    out, _, _ = video_io.read_video(str(tmp_path / "t" / "video" / "a.mp4"))
    assert out.shape == (2, 32, 32, 3)

    again = NoisedCalls(tpipe.pipe, False)  # every clip is in the ledger: nothing runs
    agg2 = evaluate_directory(again, str(root / "clips"), str(tmp_path / "t"), **kw)
    assert again.calls == 0 and agg2 == agg
    assert len(read("t")) == 2


def test_evaluate_directory_refuses_an_empty_directory(tmp_path):
    (tmp_path / "none").mkdir()
    with pytest.raises(ValueError, match="no clips"):
        evaluate_directory(SimpleNamespace(device=torch.device("cpu")), str(tmp_path / "none"),
                           str(tmp_path / "out"))
