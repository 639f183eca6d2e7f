"""ctypes binding of the host-side pixel conversions and the frame ring
(``csrc/frameproc.cpp``; the ring's Python face is ``utils/stream.py``).

Port of ``upscale_a_video_tpu/utils/native_frameproc.py`` without its numpy
fallback: the library is built at first use with the host C++ compiler
(``c++``, the one ``nvcc`` uses) into ``upscale_a_video_tpu_torch/_build/``,
under a name that carries a hash of the source and the flags, and a failed
build raises. Beside each native function stands its plain numpy version
(``*_plain``): the same float32 operations in the same order, which the
native result equals bit for bit. The CLI calls the native ones; the plain
ones are there for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "frameproc.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libframeproc_{h}.so"


def build() -> Path:
    """Compile ``csrc/frameproc.cpp`` unless this exact source is built.
    Raises ``RuntimeError`` when the compiler fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["c++", *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run the host C++ compiler: {e}") from e
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            handle.fp_normalize_u8.argtypes = [p, p, i64, i64, i]
            handle.fp_denormalize_f32.argtypes = [p, p, i64, i64, i]
            handle.fp_area_downsample4.argtypes = [p, p, i64, i64, i64, i64, i]
            for fn in (handle.fp_normalize_u8, handle.fp_denormalize_f32,
                       handle.fp_area_downsample4):
                fn.restype = None
            for name, args, res in (("create", [i64, i64], p), ("destroy", [p], None),
                                    ("close", [p], None), ("reserve", [p, i], i64),
                                    ("slot", [p, i64], p), ("commit", [p, i64], None),
                                    ("pop", [p, i], i64), ("release", [p, i64], None),
                                    ("pending", [p], i64)):
                fn = getattr(handle, f"fp_ring_{name}")
                fn.argtypes, fn.restype = args, res
            _lib = handle
    return _lib


def _threads() -> int:
    return min(os.cpu_count() or 1, 16)


def _frames(frames: np.ndarray, dtype, ndim: Optional[int] = None) -> np.ndarray:
    """``frames`` as a C-contiguous array of ``dtype`` with a frame axis;
    raises for another dtype or rank (a pointer into it goes to C)."""
    frames = np.asarray(frames)
    if frames.dtype != dtype:
        raise ValueError(f"expected {np.dtype(dtype).name} frames, got {frames.dtype}")
    if frames.ndim < 1 or (ndim is not None and frames.ndim != ndim):
        raise ValueError(f"expected {ndim or 'one or more'} axes, got shape {frames.shape}")
    return np.ascontiguousarray(frames)


def normalize_u8(frames: np.ndarray) -> np.ndarray:
    """(T, ...) uint8 → float32 in [-1, 1] (ref inference_upscale_a_video.py:180)."""
    frames = _frames(frames, np.uint8)
    out = np.empty(frames.shape, dtype=np.float32)
    lib().fp_normalize_u8(frames.ctypes.data, out.ctypes.data, frames.shape[0],
                          frames[0].size, _threads())
    return out


def normalize_u8_plain(frames: np.ndarray) -> np.ndarray:
    return (frames.astype(np.float32) / np.float32(255) - np.float32(0.5)) * np.float32(2)


def denormalize_f32(frames: np.ndarray) -> np.ndarray:
    """(T, ...) float32 in [-1, 1] → uint8, truncated (ref :357-359)."""
    frames = _frames(frames, np.float32)
    out = np.empty(frames.shape, dtype=np.uint8)
    lib().fp_denormalize_f32(frames.ctypes.data, out.ctypes.data, frames.shape[0],
                             frames[0].size, _threads())
    return out


def denormalize_f32_plain(frames: np.ndarray) -> np.ndarray:
    v = frames * np.float32(0.5) + np.float32(0.5)
    return (np.clip(v, np.float32(0), np.float32(1)) * np.float32(255)).astype(np.uint8)


def area_downsample4(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, C) float32 → (T, H // 4, W // 4, C): 4×4 box average (torch
    ``F.interpolate(mode="area")`` at factor 4, ref :184-185)."""
    frames = _frames(frames, np.float32, ndim=4)
    t, h, w, c = frames.shape
    out = np.empty((t, h // 4, w // 4, c), dtype=np.float32)
    lib().fp_area_downsample4(frames.ctypes.data, out.ctypes.data, t, h, w, c, _threads())
    return out


def area_downsample4_plain(frames: np.ndarray) -> np.ndarray:
    t, h, w, c = frames.shape
    boxes = frames[:, :h // 4 * 4, :w // 4 * 4].reshape(t, h // 4, 4, w // 4, 4, c)
    acc = np.zeros((t, h // 4, w // 4, c), dtype=np.float32)
    for dy in range(4):
        row = boxes[:, :, dy]  # (T, H // 4, W // 4, 4, C)
        acc = acc + (((row[..., 0, :] + row[..., 1, :]) + row[..., 2, :]) + row[..., 3, :])
    return acc * np.float32(1 / 16)
