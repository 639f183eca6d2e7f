"""The port pipeline's options that the CLI, serving and eval call, against
the JAX pipeline (``step_mode="host"``) on the CPU: both load the same tiny
bundle (``tests/torch_bundle.py``, video VAE) in float32 and run 2 DDIM
steps, CFG 6, noise level 120, on identical numpy-seeded inputs, initial
latents and LR noise.

- ``window_group`` 0, 1, 2 at T = 14 (unique windows 0, 6: G = 2 is one
  call) and 2 at T = 26 (windows 0, 6, 12, 18: two calls of two), with the
  port's UNet calls counted per step;
- ``return_latents`` and the ``progress_cb`` ticks;
- guidance 1 (no CFG: one row per window, no ``cfg_dup``), in one call and
  one window a call;
- ``enable_model_offload`` on and off.

Tolerance: 1e-3 absolute on outputs in [-1, 1] and on the latents (at most
a few units): float32 rounding of the same convolutions in another order,
through 2 steps of the UNet and the decode, as ``test_torch_pipeline.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bundle import write_bundle
from upscale_a_video_tpu.pipeline.loader import load_pipeline as jax_load_pipeline
from upscale_a_video_tpu_torch.ops import _cuda
from upscale_a_video_tpu_torch.pipeline import load_pipeline

torch.set_num_threads(1)

STEPS, H, W, ATOL = 2, 8, 8, 1e-3


class Options:
    """Both pipelines on one bundle, and each JAX run once per setting."""

    def __init__(self, root):
        self.jax = jax_load_pipeline(str(root), use_video_vae=True, dtype=jnp.float32,
                                     decode_dtype=jnp.float32)
        self.jax.step_mode = "host"
        self.port = load_pipeline(str(root), use_video_vae=True, dtype=torch.float32,
                                  device="cpu")
        self.port.step_mode = "host"  # JAX's mode above: a progress tick per step
        self._memo = {}

    @staticmethod
    def inputs(frames):
        rng = np.random.default_rng(frames)
        return (rng.uniform(-1, 1, (1, frames, H, W, 3)).astype(np.float32),
                rng.standard_normal((1, frames, H, W, 4)).astype(np.float32),
                rng.standard_normal((1, frames, H, W, 3)).astype(np.float32))

    def run_jax(self, frames, group=0, guidance=6.0):
        """(images, latents, progress ticks) of the JAX pipeline."""
        key = (frames, group, guidance)
        if key not in self._memo:
            image, latents, lr_noise = self.inputs(frames)
            pipe, ticks = self.jax, []
            pipe.window_group = group
            images, lat = pipe("a clip", jnp.asarray(image), num_inference_steps=STEPS,
                               guidance_scale=guidance,
                               latents=jnp.asarray(latents), lr_noise=jnp.asarray(lr_noise),
                               return_latents=True,
                               progress_cb=lambda *tick: ticks.append(tick))
            self._memo[key] = np.asarray(images), np.asarray(lat), ticks
        return self._memo[key]

    def run_port(self, frames, group=0, **kwargs):
        """The port's output and the rows of each of its UNet calls."""
        image, latents, lr_noise = self.inputs(frames)
        pipe = self.port
        pipe.window_group = group
        rows = []
        hook = pipe.m.unet.register_forward_pre_hook(lambda m, a: rows.append(a[0].shape[0]))
        try:
            out = pipe("a clip", torch.from_numpy(image), num_inference_steps=STEPS,
                       latents=torch.from_numpy(latents), lr_noise=torch.from_numpy(lr_noise),
                       **kwargs)
        finally:
            hook.remove()
        return out, rows


@pytest.fixture(scope="module")
def opts(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundle")
    write_bundle(root, video=True)
    return Options(root)


@pytest.mark.parametrize("frames,group,rows", [
    (14, 0, [2]), (14, 1, [1, 1]), (14, 2, [2]), (26, 2, [2, 2])],
    ids=["T14-G0", "T14-G1", "T14-G2-one-call", "T26-G2-grouped"])
def test_window_group_matches_jax(opts, frames, group, rows):
    """``rows``: the UNet calls of one step and the windows (x 1 clip) each
    takes before the CFG duplication."""
    want = opts.run_jax(frames, group)[0]
    got, seen = opts.run_port(frames, group)
    assert seen == rows * STEPS
    assert got.shape == want.shape == (1, frames, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_return_latents_and_progress_ticks_match_jax(opts):
    want, want_lat, want_ticks = opts.run_jax(14)
    ticks = []
    got, lat = opts.run_port(14, return_latents=True,
                             progress_cb=lambda *tick: ticks.append(tick))[0]
    assert lat.dtype == torch.float32 and lat.shape == want_lat.shape == (1, 14, H, W, 4)
    np.testing.assert_allclose(lat.numpy(), want_lat, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert ticks == want_ticks == ([("denoise", i + 1, STEPS) for i in range(STEPS)]
                                   + [("decode", k + 1, 5) for k in range(5)])


@pytest.mark.parametrize("group,rows", [(0, [2]), (1, [1, 1])], ids=["G0", "G1"])
def test_without_cfg_matches_jax(opts, group, rows):
    """Guidance 1: the UNet gets one row per window and no ``cfg_dup``."""
    want = opts.run_jax(14, group, guidance=1.0)[0]
    got, seen = opts.run_port(14, group, guidance_scale=1.0)
    assert seen == rows * STEPS
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_model_offload_gives_the_same_output(opts):
    """With offload the UNet and VAE live on the host between their stages
    (here the device is the host too, so only the bookkeeping runs) and the
    kernel operands cached from their weights are dropped; the output is the
    same, bit for bit."""
    pipe = opts.port
    resident = opts.run_port(5)[0]
    w = pipe.m.unet.conv_in.weight
    _cuda.cached(w, "probe", lambda t: t * 2)
    pipe.enable_model_offload()
    try:
        assert pipe._offload and "_uav_cached" not in w.__dict__
        offloaded = opts.run_port(5)[0]
        assert all(p.device.type == "cpu" for p in pipe.m.unet.parameters())
    finally:
        pipe.enable_model_offload(False)
    assert not pipe._offload
    assert torch.equal(offloaded, resident)
