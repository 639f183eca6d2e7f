"""Host-side video/frame IO (ref utils.py:9-36, inference_upscale_a_video.py:341-361).

Copy of ``upscale_a_video_tpu/utils/video_io.py``. Codec work stays on the
host; arrays cross to the card once per clip. Backend order: OpenCV, then
imageio/pyav; PNG frames via PIL or cv2. Each backend is imported inside the
function that uses it, so the package imports on a machine that has none of
them (the card machine); only these functions need one.
"""

from __future__ import annotations

import io
import os
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

VIDEO_EXTENSIONS = (".mp4", ".mov", ".avi", ".mkv", ".webm", ".MP4", ".MOV")
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".PNG", ".JPG")


def read_video(path: str) -> Tuple[np.ndarray, float, str]:
    """Returns (frames (T, H, W, 3) RGB uint8, fps, clip_name)."""
    p = Path(path)
    if p.is_dir():
        return _read_image_folder(p)
    try:
        return _read_video_cv2(path), _probe_fps_cv2(path), p.stem
    except Exception:
        import imageio.v3 as iio

        frames = iio.imread(path, plugin="pyav")
        meta = iio.immeta(path, plugin="pyav")
        return np.asarray(frames), float(meta.get("fps", 25.0)), p.stem


def _read_video_cv2(path: str) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cv2 cannot open {path}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def _probe_fps_cv2(path: str) -> float:
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    cap.release()
    return float(fps)


def probe_fps(path: str, default: float = 25.0) -> float:
    """The clip's frame rate as cv2 reads it; ``default`` where cv2 reads
    none (an image folder, an unreadable file) or is not installed (the JAX
    serving predictor's rule)."""
    try:
        return _probe_fps_cv2(path)
    except ImportError:
        return default


def _read_image_folder(folder: Path) -> Tuple[np.ndarray, float, str]:
    files = sorted(f for f in folder.iterdir() if f.suffix in IMAGE_EXTENSIONS)
    if not files:
        raise ValueError(f"no images in {folder}")
    try:
        from PIL import Image

        frames = np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])
    except ImportError:
        import cv2

        frames = np.stack(
            [cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB) for f in files]
        )
    return frames, 25.0, folder.name


def to_model_range(frames_u8: np.ndarray) -> np.ndarray:
    """(T,H,W,3) uint8 → float32 [-1, 1] (ref inference_upscale_a_video.py:180),
    by the port's native frameproc (``csrc/frameproc.cpp``)."""
    from . import native_frameproc

    return native_frameproc.normalize_u8(np.ascontiguousarray(frames_u8))


def from_model_range(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] → uint8, truncated (ref :357-359), by the native frameproc."""
    from . import native_frameproc

    return native_frameproc.denormalize_f32(np.asarray(frames, dtype=np.float32))


def write_video(path: str, frames_u8: np.ndarray, fps: float = 25.0,
                quality: int = 8) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        _write_video_cv2(path, frames_u8, fps)
    except Exception:
        import imageio

        imageio.mimwrite(path, frames_u8, fps=fps, quality=quality,
                         output_params=["-loglevel", "error"])


def _write_video_cv2(path: str, frames_u8: np.ndarray, fps: float) -> None:
    import cv2

    t, h, w, _ = frames_u8.shape
    fourcc = cv2.VideoWriter_fourcc(*("mp4v" if path.endswith(".mp4") else "XVID"))
    writer = cv2.VideoWriter(path, fourcc, fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cv2 cannot open writer for {path}")
    for frame in frames_u8:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        raise IOError(f"cv2 wrote empty file {path}")


def write_frames(folder: str, frames_u8: np.ndarray) -> None:
    os.makedirs(folder, exist_ok=True)
    try:
        from PIL import Image

        for i, frame in enumerate(frames_u8):
            Image.fromarray(frame).save(os.path.join(folder, f"{i:04d}.png"))
    except ImportError:
        import cv2

        for i, frame in enumerate(frames_u8):
            cv2.imwrite(os.path.join(folder, f"{i:04d}.png"),
                        cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))


def encode_png(frame_u8: np.ndarray) -> bytes:
    """One (H, W, 3) uint8 frame as PNG bytes (PIL, else cv2)."""
    try:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(frame_u8).save(buf, format="PNG")
        return buf.getvalue()
    except ImportError:
        import cv2

        ok, data = cv2.imencode(".png", cv2.cvtColor(frame_u8, cv2.COLOR_RGB2BGR))
        if not ok:
            raise IOError("cv2 could not encode the frame as PNG")
        return data.tobytes()


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → one (H, W, 3) RGB uint8 frame (PIL, else cv2)."""
    try:
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except ImportError:
        import cv2

        frame = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if frame is None:
            raise IOError("cv2 could not decode the PNG")
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)


def get_video_paths(folder: str) -> List[str]:
    return sorted(
        str(Path(folder) / f)
        for f in os.listdir(folder)
        if f.endswith(VIDEO_EXTENSIONS)
    )


def stream_video(path: str, batch: int = 8) -> Iterator[np.ndarray]:
    """Yield (n<=batch, H, W, 3) RGB uint8 frame batches WITHOUT staging the
    whole video in memory (cv2 frame-by-frame decode; image folders yield
    per-batch too). Host-memory footprint is one batch + the codec state —
    the bounded-ingest producer for serving (worker ring streaming)."""
    import cv2

    p = Path(path)
    if p.is_dir():
        frames, _fps, _ = _read_image_folder(p)
        for s in range(0, len(frames), batch):
            yield frames[s:s + batch]
        return
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cv2 cannot open {path}")
    try:
        buf = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            buf.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if len(buf) == batch:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)
    finally:
        cap.release()


class VideoWriter:
    """Incremental mp4 writer (cv2): frames append as they are produced, so
    a long run never stages the whole upscaled video host-side."""

    def __init__(self, path: str, fps: float = 25.0):
        import cv2

        self._cv2 = cv2
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.fps = float(fps)
        self._writer = None

    def append(self, frames_u8: np.ndarray) -> None:
        """frames_u8: (T, H, W, 3) RGB uint8."""
        cv2 = self._cv2
        if self._writer is None:
            h, w = frames_u8.shape[1:3]
            fourcc = cv2.VideoWriter_fourcc(
                *("mp4v" if self.path.endswith(".mp4") else "XVID"))
            self._writer = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
            if not self._writer.isOpened():
                raise IOError(f"cv2 cannot open writer for {self.path}")
        for frame in frames_u8:
            self._writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None
            if not os.path.exists(self.path) or os.path.getsize(self.path) == 0:
                raise IOError(f"cv2 wrote empty file {self.path}")
