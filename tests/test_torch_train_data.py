"""The port's training data (``training/data.py``) and prefetcher
(``utils/prefetch.py``) against the JAX package's on the CPU, float32.

Degradations: the blur (per-clip sigma, edge padding), the noise (JAX's
noise passed in), the blocking proxy, ``degrade_clip`` and
``make_train_batch`` with JAX's draws (``degrade_clip``'s four keys)
replayed through the ``draws`` seam; the generator route is seeded. The
prefetcher: order, the transform, an error raised again at the consumer
after the items before it (JAX ``tests/test_train_data.py:62-80``),
``buffer_size`` bounding how far the feeder runs ahead, and ``ClipPrefetcher``
over a frame folder.

Tolerance: 1e-5 absolute (values in [-1, 1]; the same sums in another order).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_a_video_tpu.training import data as jdata
from upscale_a_video_tpu_torch.training import data as tdata
from upscale_a_video_tpu_torch.utils.prefetch import ClipPrefetcher, device_prefetch

torch.set_num_threads(1)

ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def uniform(key, shape, lo=-1.0, hi=1.0):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(key), shape, minval=lo, maxval=hi))


def jax_draws(key, hr, scale=4):
    """degrade_clip's draws for ``key`` (JAX ``data.py:82-92``)."""
    b, t, hh, ww, c = hr.shape
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"sigma": jax.random.uniform(k1, (b,), minval=0.2, maxval=3.0),
            "noise_sigma": jax.random.uniform(k2, (b,), minval=0.0, maxval=0.1),
            "noise": jax.random.normal(k3, (b, t, hh // scale, ww // scale, c)),
            "quality": jax.random.uniform(k4, (b,), minval=0.6, maxval=1.0)}


@pytest.mark.parametrize("sigma", [[0.5, 2.5], [1e-4, 3.0]])
def test_blur_matches_jax(sigma):
    x = uniform(0, (2, 2, 20, 24, 3))
    want = np.asarray(jdata.gaussian_blur(jnp.asarray(x), jnp.asarray(sigma)))
    got = tdata.gaussian_blur(T(x), T(sigma))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_noise_matches_jax():
    x = uniform(1, (2, 2, 8, 8, 3))
    sig = np.array([0.01, 0.2], np.float32)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jdata.add_gaussian_noise(key, jnp.asarray(x), jnp.asarray(sig)))
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    got = tdata.add_gaussian_noise(T(x), T(sig), noise=T(noise))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    drawn = tdata.add_gaussian_noise(T(np.zeros_like(x)), T(sig),
                                     generator=torch.Generator().manual_seed(0))
    assert drawn[0].std() < drawn[1].std()


@pytest.mark.parametrize("shape", [(1, 2, 16, 16, 3), (2, 1, 20, 27, 3)])
def test_blocking_matches_jax(shape):
    x = uniform(3, shape)
    q = np.linspace(0.0, 1.0, shape[0]).astype(np.float32)
    want = np.asarray(jdata.jpeg_like_artifacts(jnp.asarray(x), jnp.asarray(q)))
    np.testing.assert_allclose(tdata.jpeg_like_artifacts(T(x), T(q)).numpy(), want, atol=ATOL)


def test_degrade_clip_matches_jax():
    hr = uniform(4, (2, 3, 64, 48, 3))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jdata.degrade_clip(key, jnp.asarray(hr)))
    draws = {k: T(v) for k, v in jax_draws(key, hr).items()}
    got = tdata.degrade_clip(T(hr), draws=draws)
    assert got.shape == (2, 3, 16, 12, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_degrade_clip_from_a_generator():
    hr = T(uniform(6, (2, 2, 32, 32, 3)))
    run = lambda seed: tdata.degrade_clip(hr, generator=torch.Generator().manual_seed(seed))
    a, b = run(0), run(0)
    assert torch.equal(a, b) and not torch.equal(a, run(1))
    assert a.shape == (2, 2, 8, 8, 3) and a.abs().max() <= 1.0


def test_make_train_batch_matches_jax():
    hr = uniform(7, (1, 2, 32, 32, 3))
    ctx = uniform(8, (1, 5, 16))
    key = jax.random.PRNGKey(9)
    encode = lambda x: x[:, :, ::4, ::4, :1].repeat(4, axis=-1)
    want = jdata.make_train_batch(key, jnp.asarray(hr), encode, jnp.asarray(ctx), 0.08333)
    k_deg, _ = jax.random.split(key)
    draws = {k: T(v) for k, v in jax_draws(k_deg, hr).items()}
    got = tdata.make_train_batch(T(hr), lambda x: x[:, :, ::4, ::4, :1].repeat(1, 1, 1, 1, 4),
                                 T(ctx), 0.08333, draws=draws)
    for name in ("latents", "low_res", "text_embeds"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=ATOL,
                                   err_msg=name)
    assert got["latents"].shape == (1, 2, 8, 8, 4) and got["low_res"].shape == (1, 2, 8, 8, 3)


def test_prefetch_keeps_order_and_copies():
    items = [np.full((2, 2), i, np.float32) for i in range(5)]
    out = list(device_prefetch(iter(items), buffer_size=2, device="cpu"))
    assert len(out) == 5
    for i, x in enumerate(out):
        assert isinstance(x, torch.Tensor)
        np.testing.assert_array_equal(x.numpy(), i)


def test_prefetch_transform_and_nesting():
    items = [{"frames": np.ones((2,), np.float32), "name": f"c{i}"} for i in range(3)]
    out = list(device_prefetch(iter(items), device="cpu",
                               transform=lambda d: {**d, "frames": d["frames"] * 2}))
    assert [d["name"] for d in out] == ["c0", "c1", "c2"]
    for d in out:
        np.testing.assert_array_equal(d["frames"].numpy(), 2.0)


def test_prefetch_error_propagates_after_the_items_before_it():
    def gen():
        yield np.ones((1,), np.float32)
        raise RuntimeError("decode failed")

    it = device_prefetch(gen(), device="cpu")
    np.testing.assert_array_equal(next(it).numpy(), 1.0)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetch_runs_at_most_buffer_size_ahead():
    produced = []
    lock = threading.Lock()

    def gen():
        for i in range(10):
            with lock:
                produced.append(i)
            yield np.zeros(1, np.float32)

    it = device_prefetch(gen(), buffer_size=2, device="cpu")
    next(it)
    deadline = time.time() + 5
    while time.time() < deadline and len(produced) < 4:
        time.sleep(0.01)
    time.sleep(0.1)
    with lock:
        # one taken, two queued, one held by the blocked feeder
        assert len(produced) <= 4
    assert len(list(it)) == 9


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch(iter([np.zeros(1)])))


def test_clip_prefetcher_reads_a_frame_folder(tmp_path):
    from upscale_a_video_tpu_torch.utils import video_io

    for name, seed in (("a", 0), ("b", 1)):
        frames = np.random.default_rng(seed).integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
        video_io.write_frames(str(tmp_path / name), frames)
    clips = list(ClipPrefetcher([str(tmp_path / "a"), str(tmp_path / "b")], max_frames=2,
                                device="cpu"))
    assert [c["name"] for c in clips] == ["a", "b"]
    for c in clips:
        assert c["frames"].shape == (1, 2, 8, 8, 3) and c["frames"].dtype == torch.float32
        assert c["frames"].abs().max() <= 1.0
