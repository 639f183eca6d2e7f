"""The port's video IO (``utils/video_io.py``) and its native frame
conversions (``utils/native_frameproc.py`` over ``csrc/frameproc.cpp``)
against the JAX package's, on the CPU with the codec libraries this host
has (cv2, PIL).

- The native conversions equal their plain numpy versions and the JAX
  package's output bit for bit (the same float32 operations in the same
  order); a failed build raises, there is no fallback.
- mp4 and PNG-folder round trips: the port reads what it writes (PNG
  exactly; mp4 is lossy, so the port's decode of a file equals the JAX
  package's decode of the same file), and streams and writes incrementally
  as the JAX package does.
"""

import os

import numpy as np
import pytest

from upscale_a_video_tpu.utils import native_frameproc as j_frameproc
from upscale_a_video_tpu.utils import video_io as j_video_io
from upscale_a_video_tpu_torch.utils import native_frameproc, video_io


@pytest.fixture(scope="module")
def clip():
    """(5, 40, 56, 3) uint8: 8x8 blocks, so the codec keeps them close."""
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (5, 5, 7, 3), dtype=np.uint8)
    return np.repeat(np.repeat(blocks, 8, axis=1), 8, axis=2)


# ------------------------------------------------------------- frameproc

def test_normalize_u8_equals_plain_and_jax():
    frames = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1).repeat(3, axis=-1)
    frames = np.concatenate([frames, np.random.default_rng(1).integers(
        0, 256, (2, 4, 64, 3), dtype=np.uint8)])
    got = native_frameproc.normalize_u8(frames)
    assert got.dtype == np.float32 and got.shape == frames.shape
    np.testing.assert_array_equal(got, native_frameproc.normalize_u8_plain(frames))
    np.testing.assert_array_equal(got, j_frameproc.normalize_u8(frames))
    assert got.min() == -1.0 and got.max() == 1.0


def test_denormalize_f32_equals_plain_and_jax():
    """Clamped and truncated (never rounded): values past [-1, 1], exact
    levels and the points just below them."""
    rng = np.random.default_rng(2)
    levels = (np.arange(256, dtype=np.float32) / 255 - 0.5) * 2
    below = np.nextafter(levels, np.float32(-2))
    x = np.concatenate([rng.uniform(-1.5, 1.5, 4000).astype(np.float32), levels, below,
                        np.float32([-1, 1, 0, -0.0, 5, -5])]).reshape(2, -1, 1, 1)
    got = native_frameproc.denormalize_f32(x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, native_frameproc.denormalize_f32_plain(x))
    np.testing.assert_array_equal(got, j_frameproc.denormalize_f32(x))
    np.testing.assert_array_equal(got, (np.clip(x / 2 + 0.5, 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("shape", [(3, 16, 24, 3), (2, 18, 23, 5), (1, 4, 4, 1)])
def test_area_downsample4_equals_plain_and_jax(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    got = native_frameproc.area_downsample4(x)
    t, h, w, c = shape
    assert got.shape == (t, h // 4, w // 4, c)
    np.testing.assert_array_equal(got, native_frameproc.area_downsample4_plain(x))
    np.testing.assert_array_equal(got, j_frameproc.area_downsample4(x))
    want = x[:, :h // 4 * 4, :w // 4 * 4].reshape(t, h // 4, 4, w // 4, 4, c).mean(axis=(2, 4))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_frameproc_refuses_other_inputs_and_a_failed_build_raises(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="uint8"):
        native_frameproc.normalize_u8(np.zeros((1, 2, 2, 3), np.float32))
    with pytest.raises(ValueError, match="float32"):
        native_frameproc.denormalize_f32(np.zeros((1, 2, 2, 3), np.float64))
    with pytest.raises(ValueError, match="4 axes"):
        native_frameproc.area_downsample4(np.zeros((4, 4, 3), np.float32))
    broken = tmp_path / "frameproc.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_frameproc, "SOURCE", broken)
    monkeypatch.setattr(native_frameproc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_frameproc, "_lib", None)
    with pytest.raises(RuntimeError, match="building frameproc.cpp failed"):
        native_frameproc.normalize_u8(np.zeros((1, 2, 2, 3), np.uint8))


# -------------------------------------------------------------- video io

def test_model_range_round_trip_equals_jax():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=-1)
    x = video_io.to_model_range(u8)
    assert x.dtype == np.float32 and x.min() == -1 and x.max() == 1
    np.testing.assert_array_equal(x, j_video_io.to_model_range(u8))
    back = video_io.from_model_range(x)
    np.testing.assert_array_equal(back, j_video_io.from_model_range(x))
    # truncation, as the reference: a level comes back as itself or one below
    assert set(np.unique(u8.astype(int) - back)) == {0, 1}
    assert list(back.reshape(-1, 3)[[0, 128, 255], 0]) == [0, 128, 255]  # the JAX test's levels


def test_mp4_round_trip(clip, tmp_path):
    path = str(tmp_path / "out" / "clip.mp4")
    video_io.write_video(path, clip, fps=8)
    frames, fps, name = video_io.read_video(path)
    assert frames.shape == clip.shape and frames.dtype == np.uint8
    assert fps == 8.0 and name == "clip"
    assert np.abs(frames.astype(int) - clip).mean() < 12  # lossy codec
    jframes, jfps, jname = j_video_io.read_video(path)
    np.testing.assert_array_equal(frames, jframes)
    assert (fps, name) == (jfps, jname)
    jpath = str(tmp_path / "jax" / "clip.mp4")
    j_video_io.write_video(jpath, clip, fps=8)
    np.testing.assert_array_equal(video_io.read_video(jpath)[0], frames)
    assert video_io.get_video_paths(str(tmp_path / "out")) == [path]


def test_png_folder_round_trip(clip, tmp_path):
    folder = tmp_path / "frames"
    video_io.write_frames(str(folder), clip)
    assert sorted(os.listdir(folder)) == [f"{i:04d}.png" for i in range(len(clip))]
    frames, fps, name = video_io.read_video(str(folder))
    np.testing.assert_array_equal(frames, clip)
    assert (fps, name) == (25.0, "frames")
    assert all(np.array_equal(a, b) for a, b in
               zip(video_io.stream_video(str(folder), batch=2), j_video_io.stream_video(
                   str(folder), batch=2)))
    with pytest.raises(ValueError, match="no images"):
        video_io.read_video(str(tmp_path))


def test_stream_and_incremental_writer_equal_jax(clip, tmp_path):
    path, jpath = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    writer, jwriter = video_io.VideoWriter(path, fps=10), j_video_io.VideoWriter(jpath, fps=10)
    for w in (writer, jwriter):
        w.append(clip[:2])
        w.append(clip[2:])
        w.close()
    got = list(video_io.stream_video(path, batch=2))
    want = list(j_video_io.stream_video(jpath, batch=2))
    assert [len(b) for b in got] == [len(b) for b in want] == [2, 2, 1]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
