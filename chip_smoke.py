#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``upscale_a_video_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each announced on a flushed line with the seconds elapsed):
  1. device   card name and power limit, torch/CUDA versions; TF32 off.
  2. build    the eight CUDA kernels, one nvcc call, into
              upscale_a_video_tpu_torch/_build/ (skipped when already built).
  3. kernels  each kernel against its plain PyTorch version at every shape
              the two paths give it (plus flash at the flagship's UNet shape
              and at one shape of each head width it is built for, and the
              GroupNorm and temporal conv, which no path runs, at the shapes
              of the sites they would serve: the conv at every resblock conv
              of both paths, with the site's k and with k = 3): error, time,
              plain time, PyTorch library time where one call computes the
              same function, and the card's bound; for every kernel and its
              library call also the GPU time alone, replayed from a CUDA
              graph; for the cross-attention also its fold (M and Vo) alone.
              The fused temporal attention and the GroupNorm are also held at
              shapes that reach their other variants (T = 16, D > 256 or not
              a power of two, a bf16 bias; bf16 with C % 8 != 0, C past one
              pass of the block's threads). Each path below fails if it
              launched a kernel at a shape this phase did not check (the
              wrappers count launches by shape, ``_cuda.SHAPES``); after both
              paths, each path's launches times these per-call times give
              its kernels' seconds against their plain versions'.
  4. path 1   the 3D-VAE configuration: one full-width UNet forward at the
              slice shape with the kernels and then with the plain versions,
              same weights, and for each route the share of a forward's wall
              time in which the card runs kernels (torch.profiler), and on
              the kernel route each port kernel's device time in that
              forward beside its launches (the temporal resblock's split
              into its two convs and its GroupNorm passes); then
              VideoUpscalePipeline at released width on a 64x64, 14-frame
              clip (256x256 out), 30 DDIM steps, CFG 6, noise level 120, fp32
              3-frame VAE decode; its five kernels must launch. Then the same
              call on the plain versions (timed), and a 2-step pair.
  5. path 2   the README's video-VAE configuration: the UNet check at T = 5,
              96x160; then the pipeline on a 96x160, 5-frame clip (384x640
              out), 30 steps, CFG 6, noise level 120, the fp32 video VAE
              conditioned on the LR frames (w_lr 1.0), then the Wavelet colour
              fix. Every temporal attention must go through the fused temporal
              attention (480 launches), none through the whole-block kernel.
              The same call with the colour fix on the plain versions (timed),
              the decode alone with the kernels against the plain decode
              (relative L2 gate), and a 2-step pair against the plain
              versions.

It exits non-zero, printing no result, without a CUDA device. Any failure
raises. The last line is the JSON result; the two lines before it are the
kernels' JSON record and the card's ``nvidia-smi`` name and power limit.

    python3 chip_smoke.py --only fused_temporal_attention,fused_group_norm

runs phases 1-3 for the named kernels alone and writes their records to
chiprun_out/chip_smoke_only.json (no paths, no result line): a quick
before/after measure of a kernel, also against an older checkout's package.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from upscale_a_video_tpu_torch.config import VIDEO_VAE
from upscale_a_video_tpu_torch.ops import _cuda
from upscale_a_video_tpu_torch.ops.attention import attention_plain
from upscale_a_video_tpu_torch.ops.cross_attention_block import (
    cross_attention_block_plain, fold, fold_keys, fused_cross_attention_block)
from upscale_a_video_tpu_torch.ops.flash_attention import flash_attention
from upscale_a_video_tpu_torch.ops.fused_feedforward import (fused_feedforward,
                                                             fused_feedforward_plain)
from upscale_a_video_tpu_torch.ops.fused_groupnorm import fused_group_norm, group_norm_plain
from upscale_a_video_tpu_torch.ops.fused_temporal_attention import (fused_temporal_attention,
                                                                    temporal_attention_plain)
from upscale_a_video_tpu_torch.ops.fused_temporal_resblock import (
    fused_temporal_resblock, fused_temporal_resblock_plain)
from upscale_a_video_tpu_torch.ops.temporal_attention_block import (
    fused_temporal_attention_block, temporal_attention_block_plain)
from upscale_a_video_tpu_torch.ops.temporal_conv import temporal_conv, temporal_conv_plain
from upscale_a_video_tpu_torch.pipeline import random_pipeline
from upscale_a_video_tpu_torch.pipeline.color import apply_color_fix

T0 = time.time()
PEAK_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
PEAK_FLOPS_F32 = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = 2e-2     # max |kernel - plain| / max |plain|: a few bf16 ulps of the largest value
UNET_TOL = 5e-2       # relative L2, whole bf16 UNet (~60 rounded layers)
DECODE_TOL = 1e-2     # relative L2, fp32 decode whose one bf16 step is the mid-block attention
FRAMES, LR, STEPS = 14, 64, 30            # path 1: 64x64, 14 frames
FRAMES2, H2, W2 = 5, 96, 160              # path 2: 96x160, 5 frames
# temporal resblock sites (B, T, H, W, C, k): TemporalModule3D (k = 5, with
# temb) and the Transformer3D entry resblock (k = 3, no temb) at C <= 512,
# after the CFG duplication (path 1: 2 windows x 2 rows; path 2: 2 rows) or
# in the text-free prefix before it (half the rows)
RESBLOCK_P1 = ((4, 8, 64, 64, 256, 5), (4, 8, 64, 64, 512, 5), (2, 8, 32, 32, 256, 5),
               (4, 8, 32, 32, 512, 5), (4, 8, 32, 32, 512, 3), (4, 8, 16, 16, 512, 5),
               (4, 8, 16, 16, 512, 3), (4, 8, 8, 8, 512, 5))
RESBLOCK_P2 = ((2, 5, 96, 160, 256, 5), (2, 5, 96, 160, 512, 5), (1, 5, 48, 80, 256, 5),
               (2, 5, 48, 80, 512, 5), (2, 5, 48, 80, 512, 3), (2, 5, 24, 40, 512, 5),
               (2, 5, 24, 40, 512, 3), (2, 5, 12, 20, 512, 5))
# the temporal conv's shapes (B, T, H, W, Cin, Cout, k): every resblock conv
# of both paths, conv1 with the site's k and conv2's k = 3 (the resblock's
# conv is this conv)
CONV_SITES = tuple(dict.fromkeys((*site[:5], site[4], k) for site in RESBLOCK_P1 + RESBLOCK_P2
                                 for k in (site[5], 3)))
# feed-forward shapes (B*T, tokens, C): every transformer level of path 1
# (B*T = 32) and of path 2 (B*T = 10)
FF_SITES = ((32, 1024, 512), (32, 256, 512), (32, 64, 1024),
            (10, 3840, 512), (10, 960, 512), (10, 240, 1024))
# shapes no path gives a kernel, one for each of its built variants: flash at
# each head width (64, 128 and 256; 80 and 384 run padded to 128 and 512,
# key counts not a multiple of any tile); the conv at T > 8, Cin = 1024 !=
# Cout and a frame of 300 pixels (ragged rows and channel tiles)
FLASH_WIDTHS = ((1, 4, 1000, 64), (1, 4, 1000, 80), (1, 2, 700, 256), (1, 1, 600, 384))
CONV_WIDE = (2, 12, 15, 20, 1024, 320, 5)
# fused temporal attention (B', T, H, D): path 2's three UNet levels and T = 8,
# then one shape of each other variant (csrc/fused_temporal_attention.cu)
FTA_SITES = ((7680, 5, 8, 64), (1920, 5, 8, 64), (480, 5, 8, 128), (2048, 8, 8, 64))
FTA_OTHER = ((64, 16, 8, 64), (32, 4, 2, 320), (64, 5, 4, 48))
# GroupNorm (shape, dtype, groups): the video VAE decoder's and a UNet's
# sites, then the bf16 8-byte chunks and the multi-pass channel loop
GN_SITES = (((1, 3, 96, 160, 512), torch.float32, 32), ((1, 3, 384, 640, 128), torch.float32, 32),
            ((4, 8, 64, 64, 256), torch.bfloat16, 32))
GN_OTHER = (((2, 5, 6, 10, 100), torch.bfloat16, 4), ((2, 9, 4104), torch.float32, 8))
# each port kernel's device kernels, by a part of their demangled names, in
# the order they are tried; every other kernel is PyTorch's (cuDNN, cuBLAS,
# element-wise, the cross-attention fold's two products). BiasEpilogue is
# also the temporal conv's, and the gn_ passes also the GroupNorm's: neither
# runs in a UNet forward.
DEVICE_KERNELS = (("cab_kernel", "cross_attention_block"),
                  ("tab_", "temporal_attention_block"),
                  ("QkvAttnEpilogue", "temporal_attention_block"),
                  ("OutProjEpilogue", "temporal_attention_block"),
                  ("layernorm_kernel", "fused_feedforward"),
                  ("GegluEpilogue", "fused_feedforward"),
                  ("BiasEpilogue", "fused_feedforward"),
                  ("K1Epilogue", "fused_temporal_resblock"),
                  ("K2Epilogue", "fused_temporal_resblock"),
                  ("gn_", "fused_temporal_resblock"),
                  ("fta_", "fused_temporal_attention"),
                  ("flash_wgmma_kernel", "flash_attention"))
PATH1_KERNELS = ("temporal_attention_block", "fused_temporal_resblock", "cross_attention_block",
                 "fused_feedforward", "flash_attention")
PATH2_KERNELS = ("fused_temporal_attention", "fused_temporal_resblock", "cross_attention_block",
                 "fused_feedforward", "flash_attention")

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
    "fused_temporal_attention": ("upscale_a_video_tpu_torch/csrc/fused_temporal_attention.cu",
                                 "upscale_a_video_tpu/ops/fused_temporal_attention.py:95"),
    "fused_group_norm": ("upscale_a_video_tpu_torch/csrc/fused_groupnorm.cu",
                         "upscale_a_video_tpu/ops/fused_groupnorm.py:90"),
    "temporal_conv": ("upscale_a_video_tpu_torch/csrc/temporal_conv.cu",
                      "upscale_a_video_tpu/ops/temporal_conv.py:81"),
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


def graph_ms(fn, calls: int = 20) -> float:
    """GPU time per call of ``fn`` replayed from a CUDA graph: the call's
    device work without the host's launch work."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up on a side stream, as graph capture wants
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps=5) / calls


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_FLOPS):
    t_b, t_f = nbytes / PEAK_BYTES, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def taps(k: int, t: int) -> int:
    """Temporal taps of a (k,1,1) SAME conv that land inside [0, t), summed
    over the t frames."""
    return sum(min(t, f + k // 2 + 1) - max(0, f - k // 2) for f in range(t))


def trace_ms(fn, calls: int = 5):
    """Device time in ms per launch of each kernel that ``fn`` launches, by
    its name without namespaces and arguments (torch.profiler over ``calls``
    calls; a mean per launch, as a single profiled call can miss its first
    kernel)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        if e.device_time_total:
            name = re.sub(r"(void |uav::|\(anonymous namespace\)::)", "", e.key).split("(")[0]
            total[name] = total.get(name, 0.0) + e.device_time_total / 1e3
            count[name] = count.get(name, 0) + e.count
    return {k: v / count[k] for k, v in total.items()}


def compare(name, shape, kern, plain, nbytes_, flops, library=None, peak=PEAK_FLOPS,
            trace=False):
    """Check ``kern`` against ``plain`` and time both (and ``library``), and
    the kernel's and the library's GPU time alone (:func:`graph_ms`); with
    ``trace``, also the device time per launch of each kernel it launches."""
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name} {shape}: bad output {tuple(out.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    lib_ms = cuda_ms(library) if library is not None else None
    b_ms, b_by = bound_ms(nbytes_, flops, peak)
    rec = dict(name=name, shape=shape, max_abs_err=err, rel_err=rel, tol=KERNEL_TOL, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               graph_ms=graph_ms(kern),
               library_graph_ms=graph_ms(library) if library is not None else None)
    if trace:
        rec["trace_ms"] = trace_ms(kern)
    log(json.dumps(rec))
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its plain version "
                             f"(max |err| / max |ref| = {rel:.3e} > {KERNEL_TOL})")
    return rec


def check_kernels(only=None):
    """Every kernel at its shapes (:func:`compare`), or the kernels named in
    ``only``."""
    recs = []
    inp = Inputs(1)
    want = lambda name: only is None or name in only
    # 1. temporal attention block: every UNet transformer level of path 1
    for s, c in ((1024, 512), (256, 512), (64, 1024)) if want("temporal_attention_block") else ():
        x = inp.normal(32, s, c)
        lw, lb = inp.norm(c)
        wq, wk, wv, wo = (inp.weight(c, c) for _ in range(4))
        bo = inp.normal(c, scale=0.1)
        bias = inp.normal(8, 8, 8, dtype=torch.float32)
        args = (x, lw, lb, wq, wk, wv, wo, bo, bias)
        tokens = x.shape[0] * s
        recs.append(compare(
            "temporal_attention_block", [32, s, c, 8],
            lambda: fused_temporal_attention_block(*args, video_length=8, add_residual=True),
            lambda: temporal_attention_block_plain(*args, 8, 32, 1e-5, True),
            nbytes(x, x, lw, lb, wq, wk, wv, wo, bo, bias),
            tokens * (8 * c * c + 4 * 8 * c)))
    # 2. temporal resblock at every site of both paths
    for (batch, t, hh, ww, c, k) in (RESBLOCK_P1 + RESBLOCK_P2
                                     if want("fused_temporal_resblock") else ()):
        x = inp.normal(batch, t, hh, ww, c)
        n1w, n1b = inp.norm(c)
        n2w, n2b = inp.norm(c)
        w1 = inp.weight(c, c, k, 1, 1, fan_in=c * k)
        w2 = inp.weight(c, c, 3, 1, 1, fan_in=c * 3)
        b1, b2 = inp.normal(c, scale=0.1), inp.normal(c, scale=0.1)
        temb = inp.normal(batch, c, dtype=torch.float32) if k == 5 else None
        args = (x, n1w, n1b, w1, b1, temb, n2w, n2b, w2, b2)
        rows = batch * hh * ww  # pixels; taps counted over the T frames
        recs.append(compare(
            "fused_temporal_resblock", [batch, t, hh, ww, c, k],
            lambda: fused_temporal_resblock(*args, groups=32, eps=1e-6),
            lambda: fused_temporal_resblock_plain(*args, 32, 1e-6),
            nbytes(x, x, w1, w2, b1, b2, n1w, n1b, n2w, n2b),
            2.0 * rows * c * c * (taps(k, t) + taps(3, t)), trace=True))
    # 3. text cross-attention at the C = 512 levels: path 1 (context (4, 77,
    # 1024), T = 8) and path 2 (context (2, 77, 1024), T = 5)
    for b, t, s in (((4, 8, 1024), (4, 8, 256), (2, 5, 3840), (2, 5, 960))
                    if want("cross_attention_block") else ()):
        ctx = inp.normal(b, 77, 1024)
        wk_, wv_ = inp.weight(512, 1024), inp.weight(512, 1024)
        k_, v_ = F.linear(ctx, wk_), F.linear(ctx, wv_)
        x = inp.normal(b * t, s, 512)
        lw, lb = inp.norm(512)
        wq, wo = inp.weight(512, 512), inp.weight(512, 512)
        bo = inp.normal(512, scale=0.1)
        m, vo = fold(wq, k_, v_, wo, 8, 64)
        recs.append(compare(
            "cross_attention_block", [b * t, s, 512, t],
            lambda: fused_cross_attention_block(x, lw, lb, wq, k_, v_, wo, bo, heads=8,
                                                dim_head=64, t_repeat=t, add_residual=True),
            lambda: cross_attention_block_plain(x, lw, lb, m.to(torch.bfloat16),
                                                vo.to(torch.bfloat16), 77, bo, t, 1e-5, True),
            nbytes(x, x, lw, lb, wq, k_, v_, wo, bo),
            float(b * t) * s * 4 * 512 * 8 * 77))
        # the fold of M and Vo, part of every call (its two products are
        # PyTorch's): its own time per call
        recs[-1]["fold_ms"] = cuda_ms(lambda: fold_keys(wq, k_, v_, wo, 8, 64))
        log(f"cross_attention_block {recs[-1]['shape']}: fold alone {recs[-1]['fold_ms']:.4f} "
            f"ms of {recs[-1]['ms']:.4f} ms per call")
    # 4. feed-forward: every transformer level of both paths
    for bt, s, c in FF_SITES if want("fused_feedforward") else ():
        x = inp.normal(bt, s, c)
        lw, lb = inp.norm(c)
        w1, b1 = inp.weight(8 * c, c), inp.normal(8 * c, scale=0.1)
        w2, b2 = inp.weight(c, 4 * c), inp.normal(c, scale=0.1)
        args = (x, lw, lb, w1, b1, w2, b2)
        recs.append(compare(
            "fused_feedforward", [bt, s, c],
            lambda: fused_feedforward(*args, add_residual=True),
            lambda: fused_feedforward_plain(*args, 1e-5, True),
            nbytes(x, x, lw, lb, w1, b1, w2, b2), float(bt) * s * 24 * c * c))
    # 5. flash attention: the VAE mid block (d = 512) in 3- and 2-frame decode
    # chunks, at path 1's 64x64 and path 2's 96x160 latent, the flagship's
    # C = 1024 UNet self-attention (40x40 latent), and the other widths
    for bsz, h, s, d in (((3, 1, 4096, 512), (2, 1, 4096, 512), (3, 1, 15360, 512),
                          (2, 1, 15360, 512), (1, 8, 1600, 128)) + FLASH_WIDTHS
                         if want("flash_attention") else ()):
        q, k, v = (inp.normal(bsz, h, s, d) for _ in range(3))
        scale = d ** -0.5
        recs.append(compare(
            "flash_attention", [bsz, h, s, s, d],
            lambda: flash_attention(q, k, v, scale),
            lambda: attention_plain(q, k, v, scale),
            nbytes(q, k, v, q), 4.0 * bsz * h * s * s * d,
            library=lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)))
    # 6. fused temporal attention: path 2's UNet levels 1-3 (T = 5, CFG rows
    # B = 2: B' = 2 * 48*80, 2 * 24*40, 2 * 12*20), and T = 8 at B' = 2048;
    # then the streaming variant (T = 16; D = 320) and idle lanes (D = 48)
    # with a bf16 bias, as the UNet's bf16 table gives it
    for bp, t, h, d in FTA_SITES + FTA_OTHER if want("fused_temporal_attention") else ():
        q, k = inp.normal(bp, t, h, d, scale=0.3), inp.normal(bp, t, h, d, scale=0.3)
        v = inp.normal(bp, t, h, d)
        bias = inp.normal(h, t, t, dtype=torch.bfloat16 if d == 48 else torch.float32)
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        mask = bias.to(torch.bfloat16)[None]
        recs.append(compare(
            "fused_temporal_attention", [bp, t, h, d],
            lambda: fused_temporal_attention(q, k, v, bias),
            lambda: temporal_attention_plain(q, k, v, bias),
            nbytes(q, k, v, bias, q), 4.0 * bp * h * t * t * d,
            library=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                           scale=1.0), trace=True))
    # 7. GroupNorm (+ SiLU): the video VAE decoder's fp32 sites (mid block at
    # the 96x160 latent, last up block at 384x640, 3-frame chunks) and a bf16
    # UNet shape, then bf16 in 8-byte chunks (C % 8 != 0) and C past one pass
    # of the block's threads (groups split between passes); the library call
    # (channels first) only without the SiLU
    for shape, dt, groups in GN_SITES + GN_OTHER if want("fused_group_norm") else ():
        c = shape[-1]
        x = inp.normal(*shape, scale=2.0, dtype=dt) + 0.5
        gw, gb = (a.to(dt) for a in inp.norm(c))
        xc = x.movedim(-1, 1).contiguous()
        peak = PEAK_FLOPS_F32 if dt == torch.float32 else PEAK_FLOPS
        for act in (None, "silu"):
            recs.append(compare(
                "fused_group_norm", [*shape, str(dt).split(".")[-1], act],
                lambda: fused_group_norm(x, gw, gb, groups, 1e-6, act),
                lambda: group_norm_plain(x, gw, gb, groups, 1e-6, act),
                nbytes(x, gw, gb, x), (8.0 if act else 5.0) * x.numel(),
                library=(lambda: F.group_norm(xc, groups, gw, gb, 1e-6)) if act is None else None,
                peak=peak, trace=True))
    # 8. temporal conv: every (k,1,1) conv of both paths' resblocks, and one
    # shape of the wider gate
    for (batch, t, hh, ww, cin, cout, k) in (CONV_SITES + (CONV_WIDE,)
                                             if want("temporal_conv") else ()):
        x = inp.normal(batch, t, hh, ww, cin)
        w = inp.weight(cout, cin, k, 1, 1, fan_in=cin * k)
        b = inp.normal(cout, scale=0.1)
        y = torch.empty(batch, t, hh, ww, cout, device="cuda", dtype=torch.bfloat16)
        xc = x.permute(0, 4, 1, 2, 3)  # channels-last 3-D view of the same memory
        recs.append(compare(
            "temporal_conv", [batch, t, hh, ww, cin, cout, k],
            lambda: temporal_conv(x, w, b), lambda: temporal_conv_plain(x, w, b),
            nbytes(x, w, b, y), 2.0 * batch * hh * ww * cin * cout * taps(k, t),
            library=lambda: F.conv3d(xc, w, b, padding=(k // 2, 0, 0))))
    return recs


def device_split(prof):
    """Device time in seconds by port kernel (DEVICE_KERNELS) and in all, from
    a torch.profiler run with CUDA activity (kernels on one stream)."""
    by_kernel, total = {}, 0.0
    for e in prof.key_averages():
        t = e.device_time_total / 1e6
        total += t
        name = next((k for part, k in DEVICE_KERNELS if part in e.key), "PyTorch")
        if t:
            by_kernel[name] = by_kernel.get(name, 0.0) + t
    return by_kernel, total


def device_parts(prof, kernel):
    """Device time in seconds of one port kernel's device kernels, by the
    name part that attributes them (DEVICE_KERNELS): the temporal resblock's
    two convs (K1Epilogue, K2Epilogue) apart from its GroupNorm passes."""
    parts = {}
    for e in prof.key_averages():
        part, name = next(((p, k) for p, k in DEVICE_KERNELS if p in e.key), (None, None))
        if name == kernel and e.device_time_total:
            parts[part] = parts.get(part, 0.0) + e.device_time_total / 1e6
    return parts


def busy_share(fn):
    """The card's kernel time during one call of ``fn``, split by port kernel
    (:func:`device_split`), the call's wall time (host clock, synchronised),
    in seconds, the wrappers' launches in the call, and the temporal
    resblock's device time by part (:func:`device_parts`)."""
    fn()
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_kernel, busy = device_split(prof)
    return (busy, wall, by_kernel, {k: v for k, v in _cuda.LAUNCHES.items() if v},
            device_parts(prof, "fused_temporal_resblock"))


def check_unet(pipe, frames: int, h: int, w: int):
    """One full-width UNet forward (CFG rows, B = 2) with the kernels and
    with the plain versions, same weights and inputs; then, for each route,
    the share of one forward's wall time in which the card runs kernels, and
    on the kernel route the card's time in each port kernel."""
    inp = Inputs(2)
    unet = pipe.m.unet
    sample = inp.normal(2, frames, h, w, 4)
    low_res = inp.normal(2, frames, h, w, 3)
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
    forward = lambda: unet(sample, 500, low_res, ctx, level, cfg_dup=True)
    with torch.no_grad():
        busy, wall, split, launches, resblock_parts = busy_share(forward)
        with _cuda.plain_path():
            plain_busy, plain_wall, _, _, _ = busy_share(forward)
    log(f"unet forward, card busy / wall (profiled): kernels {busy * 1e3:.1f} / "
        f"{wall * 1e3:.1f} ms ({busy / wall:.1%}), plain {plain_busy * 1e3:.1f} / "
        f"{plain_wall * 1e3:.1f} ms ({plain_busy / plain_wall:.1%})")
    log("unet forward, card time by kernel in context (ms, launches): " + ", ".join(
        f"{k} {v * 1e3:.3f} ({launches.get(k, '-')})"
        for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
    log("unet forward, fused_temporal_resblock's device time by part (ms): " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in resblock_parts.items()))
    return dict(rel_l2=rel, busy_s=busy, wall_s=wall, plain_busy_s=plain_busy,
                plain_wall_s=plain_wall, in_context_s=split, in_context_launches=launches,
                resblock_parts_s=resblock_parts)


def check_output(out, shape):
    log(f"output {tuple(out.shape)} finite={bool(torch.isfinite(out).all())} "
        f"min={out.min().item():.4f} max={out.max().item():.4f} std={out.std().item():.4f}")
    if tuple(out.shape) != shape:
        raise AssertionError(f"output shape {tuple(out.shape)}, expected {shape}")
    if not (torch.isfinite(out).all() and out.min() >= -1 and out.max() <= 1):
        raise AssertionError("output not finite or outside [-1, 1]")


def check_launches(path: str, launches, shapes, kernels, checked):
    """Each kernel of the path launched, and at no shape that the kernels
    phase did not hold against its plain version."""
    log(f"{path} launches: {json.dumps(launches)}")
    log(f"{path} launches by shape: {json.dumps(shapes)}")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels of {path} never launched: {missing}")
    unchecked = [(k, s) for k, by_shape in shapes.items() for s in by_shape
                 if (k, s) not in checked]
    if unchecked:
        raise AssertionError(f"{path} launched kernels at shapes the kernels phase did not "
                             f"check: {unchecked}")


def launch_shapes():
    """The launches of the last run by kernel and shape, shapes as strings."""
    return {k: {json.dumps(list(s)): n for s, n in v.items()} for k, v in _cuda.SHAPES.items()
            if v}


def kernel_seconds(shapes, by_key):
    """Per kernel, the seconds a path's launches take as isolated calls and
    their plain versions at the same calls: launches by shape times the
    kernels phase's per-call times."""
    out = {}
    for name, by_shape in shapes.items():
        recs = [(n, by_key[(name, shape)]) for shape, n in by_shape.items()]
        out[name] = {route: sum(n * r[key] for n, r in recs) / 1e3
                     for route, key in (("kernels", "ms"), ("plain", "plain_ms"))}
    return out


def run_path1(pipe, card: str, checked):
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
    launches, shapes = dict(_cuda.LAUNCHES), launch_shapes()
    fps = FRAMES / secs
    peak = torch.cuda.max_memory_allocated()
    log(f"path 1 e2e: {FRAMES} frames {LR}x{LR} -> {tuple(out.shape)} in {secs:.2f} s: "
        f"{fps:.4f} frames/s on {card}")
    log(f"max_memory_allocated={peak / 2**30:.2f} GiB")
    check_output(out, (1, FRAMES, 4 * LR, 4 * LR, 3))
    check_launches("path 1", launches, shapes, PATH1_KERNELS, checked)

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
    return dict(launches=launches, launches_by_shape=shapes, seconds=secs,
                plain_seconds=plain_secs, frames=FRAMES,
                frames_per_s=fps, peak_gib=peak / 2**30)


def run_path2(pipe, card: str, checked):
    """The README's video-VAE configuration on a short clip: every temporal
    attention of the UNet goes through the fused temporal attention (T = 5
    fits no row tile of the whole-block kernel)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    image = torch.rand((1, FRAMES2, H2, W2, 3), generator=g, device="cuda") * 2 - 1
    run = lambda steps: pipe("a video", image, num_inference_steps=steps, guidance_scale=6.0,
                             noise_level=120, w_lr=1.0,
                             generator=torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.time()
    out = run(STEPS)
    torch.cuda.synchronize()
    pipe_secs = time.time() - t0
    fixed = apply_color_fix("Wavelet", out[0], image[0])[None]
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches, shapes = dict(_cuda.LAUNCHES), launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    fps = FRAMES2 / secs
    log(f"path 2 e2e: {FRAMES2} frames {H2}x{W2} -> {tuple(fixed.shape)} in {secs:.2f} s "
        f"(pipeline {pipe_secs:.2f} s, colour fix {secs - pipe_secs:.2f} s): {fps:.4f} "
        f"frames/s on {card}")
    log(f"max_memory_allocated={peak / 2**30:.2f} GiB")
    check_output(out, (1, FRAMES2, 4 * H2, 4 * W2, 3))
    log(f"colour-fixed output finite={bool(torch.isfinite(fixed).all())} "
        f"min={fixed.min().item():.4f} max={fixed.max().item():.4f}")
    if fixed.shape != out.shape or not torch.isfinite(fixed).all():
        raise AssertionError("colour-fixed output has the wrong shape or is not finite")
    check_launches("path 2", launches, shapes, PATH2_KERNELS, checked)
    if launches["fused_temporal_attention"] != 16 * STEPS or launches["temporal_attention_block"]:
        raise AssertionError("path 2 must run its 16 temporal attentions per step through the "
                             "fused temporal attention and none through the whole-block kernel")

    # the same call and colour fix on the plain PyTorch versions, for the
    # kernels' end-to-end effect (reported, not gated, as on path 1)
    with _cuda.plain_path():
        torch.cuda.synchronize()
        t0 = time.time()
        ref = run(STEPS)
        ref_fixed = apply_color_fix("Wavelet", ref[0], image[0])[None]
        torch.cuda.synchronize()
        plain_secs = time.time() - t0
    log(f"path 2 e2e plain versions: {plain_secs:.2f} s: {FRAMES2 / plain_secs:.4f} frames/s; "
        f"mean/std kernels {fixed.mean().item():.4f}/{fixed.std().item():.4f}, plain "
        f"{ref_fixed.mean().item():.4f}/{ref_fixed.std().item():.4f}")

    # the decode alone on latents of the same shape: its time, and the decode
    # with the kernels (flash in the mid block) against the plain decode
    lat = torch.randn((1, FRAMES2, H2, W2, 4), generator=g, device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.time()
        dec = pipe.decode_latents(lat, image, 1.0)
        torch.cuda.synchronize()
        decode_secs = time.time() - t0
        with _cuda.plain_path():
            dec_ref = pipe.decode_latents(lat, image, 1.0)
    dec_rel = ((dec - dec_ref).norm() / dec_ref.norm()).item()
    log(f"path 2 decode alone (video VAE, fp32, {FRAMES2} frames): {decode_secs:.2f} s; "
        f"rel L2 kernels vs plain = {dec_rel:.3e} (tol {DECODE_TOL}), max |diff| "
        f"{(dec - dec_ref).abs().max().item():.3e}")
    if not (torch.isfinite(dec).all() and dec_rel <= DECODE_TOL):
        raise AssertionError(f"the decode with kernels disagrees with the plain decode: "
                             f"{dec_rel:.3e}")

    # a 2-step pair against the plain versions (reported, not gated)
    with _cuda.plain_path():
        ref2 = run(2)
    out2 = run(2)
    log(f"path 2, 2 steps: |kernels - plain| max {(out2 - ref2).abs().max().item():.4f} mean "
        f"{(out2 - ref2).abs().mean().item():.5f}")
    return dict(launches=launches, launches_by_shape=shapes, seconds=secs,
                pipeline_seconds=pipe_secs, plain_seconds=plain_secs,
                decode_seconds=decode_secs, decode_rel_l2=dec_rel,
                frames=FRAMES2, frames_per_s=fps,
                peak_gib=peak / 2**30)


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
    os.makedirs("chiprun_out", exist_ok=True)
    t0 = time.time()
    try:
        with open("chiprun_out/nvcc_build.log", "w") as f, contextlib.redirect_stdout(f):
            path = _cuda.build(verbose=True)
    except RuntimeError:
        with open("chiprun_out/nvcc_build.log") as f:
            print(f.read()[-8000:], file=sys.stderr)
        raise
    _cuda.lib()
    build_secs = time.time() - t0
    log(f"built {path.name} in {build_secs:.1f} s (nvcc and ptxas -v output in "
        f"chiprun_out/nvcc_build.log)")
    with open("chiprun_out/nvcc_build.log") as f:
        for line in f:  # register spills and serialized wgmma, the ptxas lines that cost time
            if ("spill" in line and " 0 bytes spill stores" not in line) or "Performance" in line:
                log(f"ptxas: {line.strip()[:200]}")

    phase("kernels")
    only = set(sys.argv[sys.argv.index("--only") + 1].split(",")) if "--only" in sys.argv else None
    recs = check_kernels(only)
    if only:
        with open("chiprun_out/chip_smoke_only.json", "w") as f:
            json.dump({"card": card, "kernels": recs}, f, indent=1)
        phase(f"done: {len(recs)} checks of {sorted(only)} (no paths run)")
        return 0
    checked = {(r["name"], json.dumps(r["shape"])) for r in recs}

    phase("path 1: model (random weights on the card)")
    t0 = time.time()
    pipe = random_pipeline(device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"built the pipeline in {time.time() - t0:.1f} s")
    phase("path 1: unet")
    unet1 = check_unet(pipe, 8, LR, LR)
    phase("path 1: e2e")
    path1 = dict(run_path1(pipe, card, checked), unet=unet1)
    del pipe
    torch.cuda.empty_cache()

    phase("path 2: model (random weights on the card, video VAE)")
    t0 = time.time()
    pipe = random_pipeline(device="cuda", seed=0, vae_config=VIDEO_VAE)
    torch.cuda.synchronize()
    log(f"built the pipeline in {time.time() - t0:.1f} s")
    phase("path 2: unet at T = 5")
    unet2 = check_unet(pipe, FRAMES2, H2, W2)
    phase("path 2: e2e")
    path2 = dict(run_path2(pipe, card, checked), unet=unet2)
    del pipe
    torch.cuda.empty_cache()

    paths = {"path1": path1, "path2": path2}
    by_key = {(r["name"], json.dumps(r["shape"])): r for r in recs}
    for name, p in paths.items():  # fault C1 in one run: the kernels against the plain route
        per_kernel = p["kernel_seconds"] = kernel_seconds(p["launches_by_shape"], by_key)
        kern, plain = (sum(v[r] for v in per_kernel.values()) for r in ("kernels", "plain"))
        each = ", ".join(f"{k} {v['kernels']:.3f}/{v['plain']:.3f}" for k, v in per_kernel.items())
        log(f"{name}: kernels as isolated calls {kern:.3f} s against their plain versions "
            f"{plain:.3f} s ({each}); e2e {p['seconds']:.2f} s against the plain route "
            f"{p['plain_seconds']:.2f} s")
    with open("chiprun_out/chip_smoke_kernels.json", "w") as f:
        json.dump({"card": card, "steps": STEPS, "build_seconds": build_secs, "paths": paths,
                   "kernels": recs}, f, indent=1)
    main_shape = {}
    for r in recs:  # the largest slice shape of each kernel stands for it
        if r["name"] not in main_shape or r["bound_ms"] > main_shape[r["name"]]["bound_ms"]:
            main_shape[r["name"]] = r
    kernels = []
    for name, r in main_shape.items():
        src, replaces = SOURCES[name]
        by_path = {p: v["launches"][name] for p, v in paths.items()}
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=sum(by_path.values()), launches_by_path=by_path,
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"],
                            shape=r["shape"]))
    phase(f"done (build {build_secs:.1f} s, whole script {time.time() - T0:.1f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
