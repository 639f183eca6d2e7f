"""Build, load and account for the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources are compiled at first use, one ``nvcc`` process
per source, all started together, and linked into one shared library with a
plain C interface (no PyTorch headers) in ``upscale_a_video_tpu_torch/_build/``.
The library's name carries a hash of the sources, so an unchanged tree never
rebuilds. Entry points are bound with ``ctypes``; each returns
``cudaGetLastError()`` and :func:`check` raises on anything but 0.

Every wrapper adds one to its entry in :data:`LAUNCHES` when it launches its
kernel, so a run can show which kernels the main path went through, and
:data:`SHAPES` counts the same launches by the shape of the call.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-lineinfo"]

KERNELS = ("temporal_attention_block", "fused_temporal_resblock", "cross_attention_block",
           "fused_feedforward", "flash_attention", "fused_temporal_attention",
           "fused_group_norm", "temporal_conv", "flash_attention_f32")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
SHAPES: Dict[str, Dict[Tuple, int]] = {name: {} for name in KERNELS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "uav_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "uav_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "uav_temporal_attention_block": [_P] * 12 + [_I] * 6 + [_F, _I, _P],
    "uav_cross_attention_block": [_P] * 7 + [_I] * 6 + [_F, _I, _P],
    "uav_fused_feedforward": [_P] * 10 + [_I, _I, _F, _I, _P],
    "uav_gn_stats": [_P] * 7 + [_I] * 6 + [_F, _F, _P],
    "uav_gn_finalize": [_P] * 5 + [_I] * 4 + [_F, _F, _P],
    "uav_resblock_conv": [_P, _P, _P, _P, _I] + [_P] * 5 + [_I] * 5 + [_P],
    "uav_fused_temporal_attention": [_P] * 5 + [_I] * 6 + [_P],
    "uav_fused_group_norm": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
    "uav_temporal_conv_bias": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_enabled = True


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libuav_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the "
                       "CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc -c`` process per source, run
    at once) and link the objects into the library, unless this exact source
    set is already built. Returns the library path; the compilers' output
    (with ``verbose``, ptxas's ``-v`` report) is printed in source order."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for cu in sorted(CSRC.glob("*.cu")):
            obj = work / f"{cu.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c", "-o",
                   str(obj), str(cu)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, _, proc in jobs:
            text = proc.communicate()[0]
            if verbose or proc.returncode:
                print(text, flush=True)
            if proc.returncode:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
        if failed:
            raise RuntimeError("; ".join(failed))
        tmp = work / "lib.so"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if verbose or proc.returncode:
            print(proc.stdout + proc.stderr, flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            handle.uav_error_string.argtypes = [ctypes.c_int]
            handle.uav_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().uav_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def count(name: str, shape: Tuple) -> None:
    """One launch of kernel ``name``; ``shape`` is the wrapper's key of the
    call (the operand shape and the sizes that set the kernel's work)."""
    LAUNCHES[name] += 1
    SHAPES[name][shape] = SHAPES[name].get(shape, 0) + 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        SHAPES[k].clear()


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card (the GEMM core's tile rule)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_tickets: Dict[torch.device, torch.Tensor] = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """``n`` zeroed unsigned counters on the card for kernels whose last
    block per sample finishes the work (the GroupNorm statistics): the block
    that draws a sample's last ticket resets it, so one set per device
    serves every launch on the stream (grown, zeroed, when a launch needs
    more)."""
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        t = _tickets[device] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


# the current stream's raw handle without building a torch.cuda.Stream (a few
# microseconds of host time per launch); builds without it take the long way
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, which kernels launch on."""
    if _raw_stream is not None:
        return _raw_stream(torch.cuda.current_device() if device.index is None else device.index)
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def operand(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """A kernel operand on the card: right dtype, contiguous and 32-byte
    aligned. Raises for a CPU tensor or a
    wrong dtype; copies a strided or misaligned view."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    t = t.contiguous()
    if t.data_ptr() % 32:
        t = t.clone()
    return t


def tma_operand(t: torch.Tensor, name: str, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A bf16 (or ``dtype``) operand that a kernel reads through a TMA tensor
    map: as :func:`operand`, and its rows a multiple of 16 bytes (the map's
    strides must be). Raises otherwise."""
    t = operand(t, dtype, name)
    if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
        raise ValueError(f"{name}: TMA needs a 16-byte-aligned base and row stride, got "
                         f"shape {tuple(t.shape)} at {t.data_ptr():#x}")
    return t


def cached(t: torch.Tensor, key: str, make: Callable[[torch.Tensor], torch.Tensor],
           also: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """``make(t)``, converted once per version of ``t``: kept on the tensor
    itself (an attribute, so outside every ``state_dict``) and made again
    when ``t`` has another storage (``data_ptr``) or was written in place
    (``_version``, which ``load_state_dict``'s copy also advances). For
    weight operands that a kernel wants in another layout or dtype; ``make``
    may also read the tensors ``also``, whose versions count as ``t``'s."""
    store = t.__dict__.setdefault("_uav_cached", {})
    stamp = tuple((u.data_ptr(), u._version) for u in (t, *also))
    hit = store.get(key)
    if hit is None or hit[0] != stamp:
        out = make(t)
        hit = store[key] = (stamp, None if out is t else out)  # no cycle through t
    return t if hit[1] is None else hit[1]


def drop_cached(module: torch.nn.Module) -> None:
    """Forget the operands :func:`cached` made from ``module``'s tensors, so
    that a module moved off the card leaves none of them there."""
    for t in (*module.parameters(), *module.buffers()):
        t.__dict__.pop("_uav_cached", None)


def weight(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """A weight as a kernel operand (:func:`operand`), converted once per
    version of the weight (:func:`cached`)."""
    return cached(t, f"operand:{dtype}", lambda w: operand(w.to(dtype), dtype, name))


class ViaPlain(torch.autograd.Function):
    """A kernel's call made differentiable as JAX's custom VJPs make the
    Pallas kernels (``upscale_a_video_tpu/ops/*.py``, ``jax.custom_vjp``):
    the forward runs the kernel on the caller's tensors with autograd off
    and saves them (the parameters themselves, not the kernel's operand
    copies); the backward re-runs the kernel's plain PyTorch version on the
    saved tensors under autograd and returns ``torch.autograd.grad`` of it.
    Arguments that are not tensors pass through (sizes, flags, None)."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.others = [None if isinstance(a, torch.Tensor) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad):
        args = list(ctx.others)
        needs = ctx.needs_input_grad[2:]
        wrt = [i for i in ctx.tensor_at if needs[i]]
        grads = [None] * len(args)
        with torch.enable_grad():
            for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
                args[i] = t.detach().requires_grad_(needs[i])
            out = ctx.plain(*args)
            got = torch.autograd.grad(out, [args[i] for i in wrt], grad, allow_unused=True)
        for i, g in zip(wrt, got):
            grads[i] = g
        return (None, None, *grads)


def differentiable(kernel: Callable, plain: Callable, *args):
    """``kernel(*args)``; through :class:`ViaPlain` when autograd records
    (grad mode on and some tensor argument requires grad), so that a
    backward pass reaches the arguments through ``plain(*args)``. Under
    ``no_grad`` (the pipeline, a captured loop) the kernel is called as it
    is and nothing is saved."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        return ViaPlain.apply(kernel, plain, *args)
    return kernel(*args)


@contextlib.contextmanager
def plain_path():
    """Inside this block the modules call the plain PyTorch versions of the
    kernels even on the card (to hold a whole model against its kernels)."""
    global _enabled
    prev, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = prev


def kernels_enabled() -> bool:
    """False inside :func:`plain_path` (a captured loop's key carries it)."""
    return _enabled


def use_kernel(x: torch.Tensor) -> bool:
    """A CUDA tensor goes to a kernel unless the plain path was asked for."""
    return x.is_cuda and _enabled


def route(x: torch.Tensor, fits: bool) -> bool:
    """Module dispatch to a fused op. On the card: when the kernel's gate
    holds and the plain path was not asked for. On the CPU the fused op's
    wrapper takes its plain version, so it is taken unless the module path
    was asked for with :func:`plain_path` (the tests exercise both)."""
    return _enabled and (fits if x.is_cuda else True)
