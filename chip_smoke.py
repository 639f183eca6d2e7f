#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``upscale_a_video_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each announced on a flushed line with the seconds elapsed):
  1. device   card name and power limit, torch/CUDA versions; TF32 off.
  2. build    the five CUDA kernels, one nvcc call, into
              upscale_a_video_tpu_torch/_build/ (skipped when already built).
  3. kernels  each kernel against its plain PyTorch version at every shape
              the main path gives it (plus flash at the flagship's UNet
              shape): error, time, plain time, PyTorch library time where one
              call computes the same function, and the card's bound.
  4. unet     one full-width UNet forward at the slice shape with the
              kernels and then with the plain versions, same weights.
  5. e2e      VideoUpscalePipeline at released width on a 64x64, 14-frame
              clip (256x256 out), 30 DDIM steps, CFG 6, noise level 120,
              fp32 3-frame VAE decode; every kernel must launch. Then the
              same call on the plain versions (timed), and a 2-step pair.

It exits non-zero, printing no result, without a CUDA device. Any failure
raises. The last line is the JSON result; the two lines before it are the
kernels' JSON record and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from upscale_a_video_tpu_torch.ops import _cuda
from upscale_a_video_tpu_torch.ops.attention import attention_plain
from upscale_a_video_tpu_torch.ops.cross_attention_block import (
    cross_attention_block_plain, fold, fused_cross_attention_block)
from upscale_a_video_tpu_torch.ops.flash_attention import flash_attention
from upscale_a_video_tpu_torch.ops.fused_feedforward import (fused_feedforward,
                                                             fused_feedforward_plain)
from upscale_a_video_tpu_torch.ops.fused_temporal_resblock import (
    fused_temporal_resblock, fused_temporal_resblock_plain)
from upscale_a_video_tpu_torch.ops.temporal_attention_block import (
    fused_temporal_attention_block, temporal_attention_block_plain)
from upscale_a_video_tpu_torch.pipeline import random_pipeline

T0 = time.time()
PEAK_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = 2e-2     # max |kernel - plain| / max |plain|: a few bf16 ulps of the largest value
UNET_TOL = 5e-2       # relative L2, whole bf16 UNet (~60 rounded layers)
FRAMES, LR, STEPS = 14, 64, 30

SOURCES = {
    "temporal_attention_block": ("upscale_a_video_tpu_torch/csrc/temporal_attention_block.cu",
                                 "upscale_a_video_tpu/ops/temporal_attention_block.py:205"),
    "fused_temporal_resblock": ("upscale_a_video_tpu_torch/csrc/fused_temporal_resblock.cu",
                                "upscale_a_video_tpu/ops/fused_temporal_resblock.py:203"),
    "cross_attention_block": ("upscale_a_video_tpu_torch/csrc/cross_attention_block.cu",
                              "upscale_a_video_tpu/ops/cross_attention_block.py:129"),
    "fused_feedforward": ("upscale_a_video_tpu_torch/csrc/fused_feedforward.cu",
                          "upscale_a_video_tpu/ops/fused_feedforward.py:95"),
    "flash_attention": ("upscale_a_video_tpu_torch/csrc/flash_attention.cu",
                        "upscale_a_video_tpu/ops/flash_attention.py:100"),
}


def phase(name: str) -> None:
    print(f"[{time.time() - T0:8.1f}s] == {name}", flush=True)


def log(msg: str) -> None:
    print(f"[{time.time() - T0:8.1f}s]    {msg}", flush=True)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Inputs:
    """Seeded random tensors on the card."""

    def __init__(self, seed: int):
        self.g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(self, *shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=self.g, device="cuda") * scale).to(dtype)

    def weight(self, *shape, fan_in=None):
        bound = 1.0 / np.sqrt(fan_in or shape[-1])
        return ((torch.rand(shape, generator=self.g, device="cuda") * 2 - 1) * bound).to(
            torch.bfloat16)

    def norm(self, c):
        return self.normal(c, scale=0.1) + 1, self.normal(c, scale=0.1)


def bound_ms(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, shape, kern, plain, nbytes_, flops, library=None):
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name} {shape}: bad output {tuple(out.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    lib_ms = cuda_ms(library) if library is not None else None
    b_ms, b_by = bound_ms(nbytes_, flops)
    rec = dict(name=name, shape=shape, max_abs_err=err, rel_err=rel, tol=KERNEL_TOL, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    log(json.dumps(rec))
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its plain version "
                             f"(max |err| / max |ref| = {rel:.3e} > {KERNEL_TOL})")
    return rec


def check_kernels():
    recs = []
    inp = Inputs(1)
    # 1. temporal attention block: every UNet transformer level
    for s, c in ((1024, 512), (256, 512), (64, 1024)):
        x = inp.normal(32, s, c)
        lw, lb = inp.norm(c)
        wq, wk, wv, wo = (inp.weight(c, c) for _ in range(4))
        bo = inp.normal(c, scale=0.1)
        bias = inp.normal(8, 8, 8, dtype=torch.float32)
        args = (x, lw, lb, wq, wk, wv, wo, bo, bias)
        tokens = x.shape[0] * s
        recs.append(compare(
            "temporal_attention_block", [32, s, c],
            lambda: fused_temporal_attention_block(*args, video_length=8, add_residual=True),
            lambda: temporal_attention_block_plain(*args, 8, 32, 1e-5, True),
            nbytes(x, x, lw, lb, wq, wk, wv, wo, bo, bias),
            tokens * (8 * c * c + 4 * 8 * c)))
    # 2. temporal resblock: TemporalModule3D (k=5, temb) at C <= 512, and the
    # Transformer3D entry resblock (k=3, no temb)
    for (hw, c, k, temb_on, batch) in ((64, 256, 5, True, 4), (32, 512, 5, True, 4),
                                       (16, 512, 5, True, 4), (64, 256, 5, True, 2),
                                       (32, 512, 3, False, 4), (16, 512, 3, False, 4)):
        x = inp.normal(batch, 8, hw, hw, c)
        n1w, n1b = inp.norm(c)
        n2w, n2b = inp.norm(c)
        w1 = inp.weight(c, c, k, 1, 1, fan_in=c * k)
        w2 = inp.weight(c, c, 3, 1, 1, fan_in=c * 3)
        b1, b2 = inp.normal(c, scale=0.1), inp.normal(c, scale=0.1)
        temb = inp.normal(batch, c, dtype=torch.float32) if temb_on else None
        args = (x, n1w, n1b, w1, b1, temb, n2w, n2b, w2, b2)
        taps = lambda kk: sum(min(8, t + kk // 2 + 1) - max(0, t - kk // 2) for t in range(8))
        rows = batch * hw * hw  # pixels; taps counted over the 8 frames
        recs.append(compare(
            "fused_temporal_resblock", [batch, 8, hw, hw, c, k],
            lambda: fused_temporal_resblock(*args, groups=32, eps=1e-6),
            lambda: fused_temporal_resblock_plain(*args, 32, 1e-6),
            nbytes(x, x, w1, w2, b1, b2, n1w, n1b, n2w, n2b),
            2.0 * rows * c * c * (taps(k) + taps(3))))
    # 3. text cross-attention at the C = 512 levels (context (4, 77, 1024))
    ctx = inp.normal(4, 77, 1024)
    wk_, wv_ = inp.weight(512, 1024), inp.weight(512, 1024)
    k_, v_ = F.linear(ctx, wk_), F.linear(ctx, wv_)
    for s in (1024, 256):
        x = inp.normal(32, s, 512)
        lw, lb = inp.norm(512)
        wq, wo = inp.weight(512, 512), inp.weight(512, 512)
        bo = inp.normal(512, scale=0.1)
        m, vo = fold(wq, k_, v_, wo, 8, 64)
        recs.append(compare(
            "cross_attention_block", [32, s, 512],
            lambda: fused_cross_attention_block(x, lw, lb, wq, k_, v_, wo, bo, heads=8,
                                                dim_head=64, t_repeat=8, add_residual=True),
            lambda: cross_attention_block_plain(x, lw, lb, m.to(torch.bfloat16),
                                                vo.to(torch.bfloat16), 77, bo, 8, 1e-5, True),
            nbytes(x, x, lw, lb, wq, k_, v_, wo, bo),
            32.0 * s * 4 * 512 * 8 * 77))
    # 4. feed-forward: every transformer level
    for s, c in ((1024, 512), (256, 512), (64, 1024)):
        x = inp.normal(32, s, c)
        lw, lb = inp.norm(c)
        w1, b1 = inp.weight(8 * c, c), inp.normal(8 * c, scale=0.1)
        w2, b2 = inp.weight(c, 4 * c), inp.normal(c, scale=0.1)
        args = (x, lw, lb, w1, b1, w2, b2)
        recs.append(compare(
            "fused_feedforward", [32, s, c],
            lambda: fused_feedforward(*args, add_residual=True),
            lambda: fused_feedforward_plain(*args, 1e-5, True),
            nbytes(x, x, lw, lb, w1, b1, w2, b2), 32.0 * s * 24 * c * c))
    # 5. flash attention: VAE mid block (3 frames, 64x64 latent, d = 512) and
    # the flagship's C = 1024 UNet self-attention (40x40 latent)
    for bsz, h, s, d in ((3, 1, 4096, 512), (1, 8, 1600, 128)):
        q, k, v = (inp.normal(bsz, h, s, d) for _ in range(3))
        scale = d ** -0.5
        recs.append(compare(
            "flash_attention", [bsz, h, s, s, d],
            lambda: flash_attention(q, k, v, scale),
            lambda: attention_plain(q, k, v, scale),
            nbytes(q, k, v, q), 4.0 * bsz * h * s * s * d,
            library=lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)))
    return recs


def check_unet(pipe):
    inp = Inputs(2)
    unet = pipe.m.unet
    sample = inp.normal(2, 8, LR, LR, 4)
    low_res = inp.normal(2, 8, LR, LR, 3)
    ctx = inp.normal(4, 77, 1024)
    level = torch.full((2,), 120, device="cuda")
    with torch.no_grad():
        out = unet(sample, 500, low_res, ctx, level, cfg_dup=True).float()
        with _cuda.plain_path():
            ref = unet(sample, 500, low_res, ctx, level, cfg_dup=True).float()
    torch.cuda.synchronize()
    rel = ((out - ref).norm() / ref.norm()).item()
    log(f"unet out {tuple(out.shape)}: rel L2 kernels vs plain = {rel:.3e} (tol {UNET_TOL}), "
        f"finite={bool(torch.isfinite(out).all())}")
    if not (torch.isfinite(out).all() and rel <= UNET_TOL):
        raise AssertionError(f"UNet with kernels disagrees with the plain UNet: {rel:.3e}")


def run_e2e(pipe, card: str):
    g = torch.Generator(device="cuda").manual_seed(3)
    image = torch.rand((1, FRAMES, LR, LR, 3), generator=g, device="cuda") * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.time()
    out = pipe("a video", image, num_inference_steps=STEPS, guidance_scale=6.0, noise_level=120,
               generator=torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    fps = FRAMES / secs
    log(f"e2e: {FRAMES} frames {LR}x{LR} -> {tuple(out.shape)} in {secs:.2f} s: {fps:.4f} "
        f"frames/s on {card}")
    log(f"output finite={bool(torch.isfinite(out).all())} min={out.min().item():.4f} "
        f"max={out.max().item():.4f} std={out.std().item():.4f}")
    log(f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches: {json.dumps(launches)}")
    if tuple(out.shape) != (1, FRAMES, 4 * LR, 4 * LR, 3):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not (torch.isfinite(out).all() and out.min() >= -1 and out.max() <= 1):
        raise AssertionError("output not finite or outside [-1, 1]")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # the same call on the plain PyTorch versions, for the kernels' end-to-end
    # effect. 30 bf16 steps with CFG 6 amplify rounding chaotically, so the
    # 30-step outputs are compared as distributions; a 2-step pair shows the
    # pointwise distance before the amplification. Reported, not gated: the
    # gates are the per-kernel and the UNet checks.
    run = lambda steps: pipe("a video", image, num_inference_steps=steps, guidance_scale=6.0,
                             noise_level=120,
                             generator=torch.Generator(device="cuda").manual_seed(4))
    with _cuda.plain_path():
        t0 = time.time()
        ref = run(STEPS)
        torch.cuda.synchronize()
        plain_secs = time.time() - t0
        ref2 = run(2)
    out2 = run(2)
    log(f"e2e plain versions: {plain_secs:.2f} s: {FRAMES / plain_secs:.4f} frames/s; "
        f"mean/std kernels {out.mean().item():.4f}/{out.std().item():.4f}, plain "
        f"{ref.mean().item():.4f}/{ref.std().item():.4f}; 30 steps |kernels - plain| max "
        f"{(out - ref).abs().max().item():.4f} mean {(out - ref).abs().mean().item():.5f}; "
        f"2 steps max {(out2 - ref2).abs().max().item():.4f} mean "
        f"{(out2 - ref2).abs().mean().item():.5f}")
    return launches, secs, plain_secs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    phase("device")
    card = smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"nvidia-smi: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    phase("build")
    t0 = time.time()
    path = _cuda.build(verbose=True)
    _cuda.lib()
    log(f"built {path.name} in {time.time() - t0:.1f} s")

    phase("kernels")
    recs = check_kernels()

    phase("model (random weights on the card)")
    t0 = time.time()
    pipe = random_pipeline(device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"built the pipeline in {time.time() - t0:.1f} s")

    phase("unet")
    check_unet(pipe)

    phase("e2e")
    launches, secs, plain_secs = run_e2e(pipe, card)

    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke_kernels.json", "w") as f:
        json.dump({"card": card, "e2e_seconds": secs, "e2e_plain_seconds": plain_secs,
                   "frames": FRAMES, "steps": STEPS,
                   "launches": launches, "kernels": recs}, f, indent=1)
    main_shape = {}
    for r in recs:  # the largest slice shape of each kernel stands for it
        if r["name"] not in main_shape or r["bound_ms"] > main_shape[r["name"]]["bound_ms"]:
            main_shape[r["name"]] = r
    kernels = []
    for name, r in main_shape.items():
        src, replaces = SOURCES[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"],
                            shape=r["shape"]))
    phase("done")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
