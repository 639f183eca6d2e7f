#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``upscale_a_video_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each announced on a flushed line with the seconds elapsed):
  1. device   card name and power limit, torch/CUDA versions; TF32 off.
  2. build    the nine CUDA kernels, one nvcc call, into
              upscale_a_video_tpu_torch/_build/ (skipped when already built).
  3. kernels  each kernel against its plain PyTorch version at every shape
              the paths give it (plus flash at the flagship's UNet shape
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
              pass of the block's threads). Flash with fp32 operands (the
              --decode_attn fp32 kernel) at every fp32 decode shape of paths
              1, 2 and 4 and at d = 160, gated at 1e-4 of max |plain|, its
              bound at the CUDA cores' fp32 rate, SDPA on the same fp32
              tensors as its library call. Each path below fails if it
              launched a kernel at a shape this phase did not check (the
              wrappers count launches by shape, ``_cuda.SHAPES``; kernels 1
              and 3 also by whether the residual is folded in: both are
              checked without it at path 1's shapes, as PAB calls them);
              after the paths, one run's launches times these per-call
              times give its kernels' seconds against their plain versions'.
  4. path 1   the 3D-VAE configuration: one full-width UNet forward at the
              slice shape with the kernels and then with the plain versions,
              same weights, and for each route the share of a forward's wall
              time in which the card runs kernels (torch.profiler), and on
              the kernel route each port kernel's device time in that
              forward beside its launches (the temporal resblock's split
              into its two convs and its GroupNorm passes); then
              VideoUpscalePipeline at released width on a 64x64, 14-frame
              clip (256x256 out), 30 DDIM steps, CFG 6, noise level 120, fp32
              3-frame VAE decode, under step_mode "host" and "scan" (the
              denoise loop as one CUDA graph once its key comes back): host
              first with no graph held, then a key's first call (eager),
              its second (capture and replay) and a warm call (replay); the
              wrappers count launches when their Python runs, so the eager
              and the capturing call each count the loop once and a replay
              none; its five kernels launched; seconds of each call, the
              calls of one key after which scan's total is below host's,
              peak allocated and reserved memory; every scan call against
              host bit for bit at 2 and 30 steps (gated at the spread of two
              eager runs, which are bit-equal); the card's busy share of
              the denoise alone under each route. Then the same call on the
              plain versions (timed), a 2-step pair, and
              PABConfig(kinds=("cross",)) under scan (eager, capture,
              replay) and host, all bit-equal: exactly 140 cross-attention
              launches (20 a forward on 7 of 30 steps), all kernel-1 and
              kernel-3 launches without the residual, frames/s, the
              distance to the exact route on the kernels and on the plain
              versions (reported); 2 steps under every kind cached from
              step 0 (step 1 broadcasts) with the kernels against the plain
              versions at the UNet's gate.
  5. path 2   the README's video-VAE configuration: the UNet check at T = 5,
              96x160; then the pipeline on a 96x160, 5-frame clip (384x640
              out), 30 steps, CFG 6, noise level 120, the fp32 video VAE
              conditioned on the LR frames (w_lr 1.0), both step modes as on
              path 1, then the Wavelet colour fix. Every temporal attention
              must go through the fused temporal attention (480 captured
              launches), none through the whole-block kernel.
              The same call with the colour fix on the plain versions (timed),
              the decode alone with the kernels against the plain decode
              (relative L2 gate), and a 2-step pair against the plain
              versions; then the same 2 steps with ``enable_model_offload()``,
              which must equal the resident call exactly (both peak
              memories printed). The decode alone also with fp32 q, k and v
              in the mid-block attention (--decode_attn fp32): the fp32
              flash kernel, once a chunk, against the plain decode at the
              decode's gate.
  6. path 3   the README's headline command with ``-p 24,26,28``: the
              pipeline from ``load_pipeline(random_init=True,
              use_video_vae=True)`` and RAFT from ``load_raft(None)`` at
              released widths; RAFT's bidirectional flows of path 2's clip
              (4 + 4 pairs, 20 iterations, fp32) timed on the card and held
              against the same RAFT on the CPU (relative L2 gate), with the
              share of pixels the consistency mask keeps in each sweep;
              ``propagate_latents`` on the card against the CPU on the same
              x̂0 and flows (RAFT's, and a consistent whole-pixel shift so
              that the warp and the fusion act);
              then the pipeline with those flows and propagation at steps 24,
              26 and 28 (30 steps, CFG 6, noise level 120, w_lr 1.0; eager,
              then captured with the propagation inside the graph) and the
              Wavelet fix: frames/s of a warm call with and without RAFT,
              peak memory, exactly 3
              propagations and 480 captured fused temporal attentions; then
              the VAE encoder on 3 output frames with the kernels against the
              plain versions (relative L2 gate; flash in its mid block).
  7. path 4   the port CLI's per-clip step (``cli.process_clip``) with the
              headline command's flags plus ``--perform_tile --tile_size 128
              --tile_batch 2`` and ``--random_weights``: the pipeline and
              RAFT from ``cli.load_models`` (video VAE, bf16 decode), a
              synthetic 14-frame 128x256 uint8 clip from a seed, in memory
              (no codec library on the card machine): two 128x192 tiles in
              one batched call, window_group 1 (windows 0 and 6),
              propagation at 24, 26, 28, Wavelet fix -> (14, 512, 1024, 3)
              uint8. Frames/s, the seconds and peak memory of RAFT, the
              denoise, the decode, the colour fix and the rest (RAFT and the
              fix timed around a sync, the denoise and decode by progress
              ticks); exactly one tile call, which propagated at 24, 26, 28;
              kernels 1-5 launched as many times as the path predicts, only
              at checked shapes, kernel 6 never; 2 steps on the first 8
              frames with ``--tile_batch 1`` against ``--tile_batch 2`` in
              fp32, step by step (the UNet's plain versions; flash in the
              decode at checked shapes), each tile
              with the same noise, in float before the uint8 conversion,
              within relative L2 1e-4; the native frame conversions equal
              their plain versions exactly on the path's frames. The CLI
              runs clips over 8 frames step by step (step_mode "host").
              Then the clip's first 8 frames (one call of two tiles, "scan")
              as a run of such clips calls them: first, second and third
              call (eager; capture and replay; replay) against host, equal
              outputs, launches as predicted, the calls of one key after
              which scan wins; then with the captioner at LLaVA-1.5-13B
              widths (bf16) on the card beside the pipeline: peak memory.
  8. path 5   the captioner: LlavaConfig() (CLIP ViT-L/14-336, LLaMA 5120 x
              40 layers x 40 heads, vocabulary 32000: 13.3 B parameters) in
              bf16 with seeded random weights drawn on the card and a byte
              tokenizer: 8 single-token decode steps against one prefill of
              the same sequence (last logits within relative L2 2e-2);
              caption() of path 4's frame 0 after the CLI's resize, greedy
              and top-p (T 0.2, p 0.7), 64 new tokens; the vision tower,
              the prefill and a decode step timed, the step against its
              bound (the decoder's weight bytes and the live KV cache over
              the card's rate), peak memory. Then the same seed in int8
              (load_8bit): its prompt logits against bf16 (reported), a
              decode step against its bound, the weight bytes of both. Then
              MPT at MPTConfig()'s widths: the same decode check. The bf16
              captioner waits in host memory for path 6.
  9. path 6   serving and eval: the controller, a worker whose Predictor
              holds load_pipeline(random_init=True) (3D VAE, bf16 decode,
              "scan") and path 5's 13B captioner, and the web demo, on
              127.0.0.1; video IO in memory (the port's read_video,
              stream_video, VideoWriter and write_video replaced by
              stand-ins over seeded uint8 clips; the native ring and the
              frame conversions real). Through the demo: R1 an 8-frame 64x64
              clip captioned by the 13B captioner, R2 the same streamed
              (NDJSON), R3 a 16-frame clip in two 8-frame segments through
              the ring (seeds s and s + 1), received while R2's loop is
              captured, R4 R1's clip, received while R3 runs. Every served
              output equal bit for bit to a direct call of the same pipeline
              on the main thread (R1's key again: eager, then captured, the
              capture's seconds against the job thread's; R3's segments
              replayed); kernels 1-5 launched at checked shapes, per request
              as predicted (R1 eager, R2 captures, R3 and R4 replay); R2's
              lines equal to the pipeline's ticks; R3 16 frames in two
              appends, its ring empty. Per request: seconds from POST to
              reply, queue, caption, denoise, decode, write, served frames/s,
              HTTP and host overhead; peak memory with the captioner. Then
              evaluate_directory over two clips with ground truth and LPIPS
              (AlexNet widths, random weights): PSNR, SSIM and LPIPS from the
              card within 1e-4 relative of the CPU's; a second run resumes
              and calls nothing.

It exits non-zero, printing no result, without a CUDA device. Any failure
raises. The last line is the JSON result; the two lines before it are the
kernels' JSON record and the card's ``nvidia-smi`` name and power limit.

    python3 chip_smoke.py --only fused_temporal_attention,fused_group_norm

runs phases 1-3 for the named kernels alone and writes their records to
chiprun_out/chip_smoke_only.json (no paths, no result line): a quick
before/after measure of a kernel, also against an older checkout's package.
``--paths 1,2,6`` runs every kernel check and then only the named paths (no
result line; records in chiprun_out/chip_smoke_kernels.json).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from upscale_a_video_tpu_torch import captioner, cli
from upscale_a_video_tpu_torch.config import VIDEO_VAE
from upscale_a_video_tpu_torch.models.llava import LlavaCaptioner, LlavaConfig, LlavaModel
from upscale_a_video_tpu_torch.models.llava.conversation import (build_caption_prompt,
                                                                 preprocess_image)
from upscale_a_video_tpu_torch.models.llava.llama import causal_prefill_mask, decode_step_mask
from upscale_a_video_tpu_torch.models.llava.mpt import MPTConfig, MPTForCausalLM
from upscale_a_video_tpu_torch.models.propagation import fb_consistency_check, propagate_latents
from upscale_a_video_tpu_torch.models.raft import RaftRunner, compute_bidirectional_flows, load_raft
from upscale_a_video_tpu_torch.nn.attention import SpatialAttentionBlock
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
from upscale_a_video_tpu_torch.ops.warp import flow_warp
from upscale_a_video_tpu_torch.pipeline import (PABConfig, chunk_starts, load_pipeline,
                                                 random_pipeline)
from upscale_a_video_tpu_torch.pipeline import graphs
from upscale_a_video_tpu_torch.pipeline.color import apply_color_fix
from upscale_a_video_tpu_torch.pipeline.eval import evaluate_directory
from upscale_a_video_tpu_torch.serving import predictor as predictor_module
from upscale_a_video_tpu_torch.serving.controller import serve_controller
from upscale_a_video_tpu_torch.serving.predictor import Predictor
from upscale_a_video_tpu_torch.serving.web_demo import serve_web_demo
from upscale_a_video_tpu_torch.serving.worker import serve_worker
from upscale_a_video_tpu_torch.utils import native_frameproc, quant, video_io
from upscale_a_video_tpu_torch.utils.lpips import LPIPS, load_lpips
from upscale_a_video_tpu_torch.utils.metrics import psnr, ssim
from upscale_a_video_tpu_torch.utils.stream import FrameRing
from upscale_a_video_tpu_torch.weights import init_random_

T0 = time.time()
PEAK_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
PEAK_FLOPS_F32 = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = 2e-2     # max |kernel - plain| / max |plain|: a few bf16 ulps of the largest value
F32_KERNEL_TOL = 1e-4  # the same for fp32 operands: float32 sums in another order (TF32 or a
                       # bf16 p would land near 1e-3)
UNET_TOL = 5e-2       # relative L2, whole bf16 UNet (~60 rounded layers)
DECODE_TOL = 1e-2     # relative L2, fp32 decode whose one bf16 step is the mid-block attention
FLOW_TOL = 1e-2       # relative L2, RAFT's fp32 flows on the card against the CPU (20 iterations)
PROP_TOL = 1e-5       # max |card - CPU|, fp32 propagation of the same x̂0 along the same flows
ENCODE_TOL = 1e-2     # relative L2, fp32 encode whose one bf16 step is the mid-block attention
TILE_TOL = 1e-4       # relative L2, 2 fp32 steps + fp32 decode: tiles batched 2 against 1 per call
DECODE_STEP_TOL = 2e-2  # relative L2, bf16 logits: single-token steps against one prefill
FRAMES, LR, STEPS = 14, 64, 30            # path 1: 64x64, 14 frames
FRAMES2, H2, W2 = 5, 96, 160              # path 2 (and 3): 96x160, 5 frames
PROP_STEPS = (24, 26, 28)                 # path 3: the headline command's -p 24,26,28
FRAMES4, H4, W4 = 14, 128, 256            # path 4: two 128x192 tiles (64 px halo) -> 512x1024
P4_ARGV = ["-n", "120", "-g", "6", "-s", str(STEPS), "-p", ",".join(map(str, PROP_STEPS)),
           "--use_video_vae", "--color_fix", "Wavelet", "--no_llava", "--perform_tile",
           "--tile_size", "128", "--tile_batch", "2", "--random_weights"]
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
# path 4: one 8-frame window of the two 128x192 tiles per UNet call (2 rows
# before the CFG duplication, 4 after): path 1's sites at 2x3 the latent
RESBLOCK_P4 = ((4, 8, 128, 192, 256, 5), (4, 8, 128, 192, 512, 5), (2, 8, 64, 96, 256, 5),
               (4, 8, 64, 96, 512, 5), (4, 8, 64, 96, 512, 3), (4, 8, 32, 48, 512, 5),
               (4, 8, 32, 48, 512, 3), (4, 8, 16, 24, 512, 5))
# path 6: one served 8-frame 64x64 clip a call, one window (2 CFG rows): path
# 1's sites at half the rows
RESBLOCK_P6 = tuple((b // 2, *site) for b, *site in RESBLOCK_P1)
# the temporal conv's shapes (B, T, H, W, Cin, Cout, k): every resblock conv
# of paths 1 and 2, conv1 with the site's k and conv2's k = 3 (the resblock's
# conv is this conv; no path launches the conv alone)
CONV_SITES = tuple(dict.fromkeys((*site[:5], site[4], k) for site in RESBLOCK_P1 + RESBLOCK_P2
                                 for k in (site[5], 3)))
# feed-forward shapes (B*T, tokens, C): every transformer level of path 1
# (B*T = 32), of path 2 (B*T = 10), of path 4 (B*T = 32) and of path 6
# (B*T = 16)
FF_SITES = ((32, 1024, 512), (32, 256, 512), (32, 64, 1024),
            (10, 3840, 512), (10, 960, 512), (10, 240, 1024),
            (32, 6144, 512), (32, 1536, 512), (32, 384, 1024),
            (16, 1024, 512), (16, 256, 512), (16, 64, 1024))
# the temporal attention block's and the cross-attention's (B*T, tokens, C)
# at the UNet levels of paths 1, 4 and 6
TAB_SITES = ((32, 1024, 512), (32, 256, 512), (32, 64, 1024),
             (32, 6144, 512), (32, 1536, 512), (32, 384, 1024),
             (16, 1024, 512), (16, 256, 512), (16, 64, 1024))
# (site, add_residual) of kernels 1 and 3: with the residual folded in at
# every site, and at path 1's sites also without it (Pyramid Attention
# Broadcast caches the attention's delta, so the add runs outside)
TAB_RUNS = tuple((site, 1) for site in TAB_SITES) + tuple((site, 0) for site in TAB_SITES[:3])
CAB_SITES = ((4, 8, 1024), (4, 8, 256), (2, 5, 3840), (2, 5, 960), (4, 8, 6144), (4, 8, 1536),
             (2, 8, 1024), (2, 8, 256))
CAB_RUNS = tuple((site, 1) for site in CAB_SITES) + tuple((site, 0) for site in CAB_SITES[:2])
# shapes no path gives a kernel, one for each of its built variants: flash at
# each head width (64, 128 and 256; 80 and 384 run padded to 128 and 512,
# key counts not a multiple of any tile); the conv at T > 8, Cin = 1024 !=
# Cout and a frame of 300 pixels (ragged rows and channel tiles)
FLASH_WIDTHS = ((1, 4, 1000, 64), (1, 4, 1000, 80), (1, 2, 700, 256), (1, 1, 600, 384))
# flash with fp32 operands (--decode_fp32 --decode_attn fp32): the VAE mid
# block's shapes in the fp32 decode of paths 1, 2 and 4 (3- and 2-frame
# chunks; path 4's two tiles batched), then d = 160 (run padded to the
# 256-wide kernel) with query and key counts that are a multiple of no tile
FLASH_F32_SITES = ((3, 1, 4096, 512), (2, 1, 4096, 512), (3, 1, 15360, 512),
                   (2, 1, 15360, 512), (6, 1, 24576, 512), (4, 1, 24576, 512),
                   (1, 4, 1000, 160))
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
ALL_PATHS = ("1", "2", "3", "4", "5", "6")
PAB_COMPUTED = (0, 1, 2, 8, 14, 20, 26)  # steps PABConfig() computes the cross-attention at
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
    "flash_attention_f32": ("upscale_a_video_tpu_torch/csrc/flash_attention_f32.cu",
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


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
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
    return cuda_ms(graph.replay, reps=replays) / calls


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
            trace=False, tol=KERNEL_TOL, reps=10, graph_calls=20):
    """Check ``kern`` against ``plain`` and time both (and ``library``), and
    the kernel's and the library's GPU time alone (:func:`graph_ms`); with
    ``trace``, also the device time per launch of each kernel it launches.
    Calls of a second or more take fewer ``reps`` and ``graph_calls``."""
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name} {shape}: bad output {tuple(out.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    del out, ref
    replays = min(reps, 5)
    ms, plain_ms = cuda_ms(kern, reps), cuda_ms(plain, reps)
    lib_ms = cuda_ms(library, reps) if library is not None else None
    b_ms, b_by = bound_ms(nbytes_, flops, peak)
    rec = dict(name=name, shape=shape, max_abs_err=err, rel_err=rel, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               graph_ms=graph_ms(kern, graph_calls, replays),
               library_graph_ms=(graph_ms(library, graph_calls, replays)
                                 if library is not None else None))
    if trace:
        rec["trace_ms"] = trace_ms(kern)
    log(json.dumps(rec))
    if not rel <= tol:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its plain version "
                             f"(max |err| / max |ref| = {rel:.3e} > {tol})")
    return rec


def timing(flops: float) -> dict:
    """Repetitions for :func:`compare`: calls of 10 ms and more (flash at the
    decode's 15360- and 24576-token shapes) are timed over fewer."""
    return dict(reps=3, graph_calls=2) if flops > 5e11 else {}


def check_kernels(only=None):
    """Every kernel at its shapes (:func:`compare`), or the kernels named in
    ``only``."""
    recs = []
    inp = Inputs(1)
    want = lambda name: only is None or name in only
    # 1. temporal attention block: every UNet transformer level of paths 1 and
    # 4, and path 1's levels without the residual (the delta PAB caches)
    for (bt, s, c), res in TAB_RUNS if want("temporal_attention_block") else ():
        x = inp.normal(bt, s, c)
        lw, lb = inp.norm(c)
        wq, wk, wv, wo = (inp.weight(c, c) for _ in range(4))
        bo = inp.normal(c, scale=0.1)
        bias = inp.normal(8, 8, 8, dtype=torch.float32)
        args = (x, lw, lb, wq, wk, wv, wo, bo, bias)
        tokens = x.shape[0] * s
        recs.append(compare(
            "temporal_attention_block", [bt, s, c, 8, res],
            lambda: fused_temporal_attention_block(*args, video_length=8, add_residual=bool(res)),
            lambda: temporal_attention_block_plain(*args, 8, 32, 1e-5, bool(res)),
            nbytes(x, x, lw, lb, wq, wk, wv, wo, bo, bias),
            tokens * (8 * c * c + 4 * 8 * c)))
    # 2. temporal resblock at every site of the paths
    for (batch, t, hh, ww, c, k) in (RESBLOCK_P1 + RESBLOCK_P2 + RESBLOCK_P4 + RESBLOCK_P6
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
    # 3. text cross-attention at the C = 512 levels: paths 1 and 4 (context
    # (4, 77, 1024), T = 8) and path 2 (context (2, 77, 1024), T = 5), and
    # path 1's levels without the residual (the delta PAB caches)
    for (b, t, s), res in CAB_RUNS if want("cross_attention_block") else ():
        ctx = inp.normal(b, 77, 1024)
        wk_, wv_ = inp.weight(512, 1024), inp.weight(512, 1024)
        k_, v_ = F.linear(ctx, wk_), F.linear(ctx, wv_)
        x = inp.normal(b * t, s, 512)
        lw, lb = inp.norm(512)
        wq, wo = inp.weight(512, 512), inp.weight(512, 512)
        bo = inp.normal(512, scale=0.1)
        m, vo = fold(wq, k_, v_, wo, 8, 64)
        recs.append(compare(
            "cross_attention_block", [b * t, s, 512, t, res],
            lambda: fused_cross_attention_block(x, lw, lb, wq, k_, v_, wo, bo, heads=8,
                                                dim_head=64, t_repeat=t,
                                                add_residual=bool(res)),
            lambda: cross_attention_block_plain(x, lw, lb, m.to(torch.bfloat16),
                                                vo.to(torch.bfloat16), 77, bo, t, 1e-5,
                                                bool(res)),
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
    # chunks, at path 1's 64x64 and path 2's 96x160 latent, and path 4's
    # 128x192 tiles two at a time (bf16 decode) and one at a time (the fp32
    # tile-batching pair); the flagship's C = 1024 UNet self-attention (40x40
    # latent), and the other widths
    for bsz, h, s, d in (((3, 1, 4096, 512), (2, 1, 4096, 512), (3, 1, 15360, 512),
                          (2, 1, 15360, 512), (6, 1, 24576, 512), (4, 1, 24576, 512),
                          (3, 1, 24576, 512), (2, 1, 24576, 512),
                          (1, 8, 1600, 128)) + FLASH_WIDTHS
                         if want("flash_attention") else ()):
        q, k, v = (inp.normal(bsz, h, s, d) for _ in range(3))
        scale = d ** -0.5
        # the plain version's fp32 scores, one batch entry at a time past 4 GiB
        per = 1 if bsz * h * s * s * 4 > 4 * 2**30 else bsz
        flops = 4.0 * bsz * h * s * s * d
        recs.append(compare(
            "flash_attention", [bsz, h, s, s, d],
            lambda: flash_attention(q, k, v, scale),
            lambda: torch.cat([attention_plain(q[i:i + per], k[i:i + per], v[i:i + per], scale)
                               for i in range(0, bsz, per)]),
            nbytes(q, k, v, q), flops,
            library=lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            **timing(flops)))
    # 5'. flash attention with fp32 operands: every product an FFMA, held at
    # the fp32 gate; the bound at the fp32 rate of the CUDA cores
    for bsz, h, s, d in FLASH_F32_SITES if want("flash_attention_f32") else ():
        q, k, v = (inp.normal(bsz, h, s, d, dtype=torch.float32) for _ in range(3))
        scale = d ** -0.5
        per = 1 if bsz * h * s * s * 4 > 4 * 2**30 else bsz
        flops = 4.0 * bsz * h * s * s * d
        recs.append(compare(
            "flash_attention_f32", [bsz, h, s, s, d],
            lambda: flash_attention(q, k, v, scale),
            lambda: torch.cat([attention_plain(q[i:i + per], k[i:i + per], v[i:i + per], scale)
                               for i in range(0, bsz, per)]),
            nbytes(q, k, v, q), flops, peak=PEAK_FLOPS_F32, tol=F32_KERNEL_TOL,
            library=lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            **timing(flops)))
        del q, k, v
        torch.cuda.empty_cache()
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
    resblock's device time by part (:func:`device_parts`). ``fn`` must
    have run before (its lazy state made)."""
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


def captured_loop(pipe, steps: int, pab=None):
    """The pipeline's captured denoise loop, which must be the one of
    ``steps`` steps under ``pab`` (fields 1 and 7 of its key)."""
    key = pipe.graphs.key
    if key is None or key[1] != steps or key[7] != pab:
        raise AssertionError(f"expected the captured {steps}-step loop under {pab}, held: "
                             f"{key and key[:8]}")
    return pipe.graphs.loop


def timed_call(run, *args):
    """``run(*args)`` between syncs: its output, wall seconds, peak allocated
    and reserved GiB, the wrappers' launches and launches by shape."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.time()
    out = run(*args)
    torch.cuda.synchronize()
    return dict(out=out, s=time.time() - t0, peak=torch.cuda.max_memory_allocated() / 2**30,
                reserved=torch.cuda.max_memory_reserved() / 2**30,
                launches=dict(_cuda.LAUNCHES), shapes=launch_shapes())


def break_even(first: float, capture: float, replay: float, host: float) -> float:
    """n such that n calls of one key take less time under "scan" than under
    "host" once the count passes n: scan runs the first call eagerly
    (``first``), captures and replays the second (``capture``) and replays
    the rest (``replay``); host takes ``host`` a call."""
    return (first + capture - 2 * replay) / (host - replay) if host > replay else float("inf")


def loop_only(launches):
    """Launches without the decode's (flash in the VAE's mid block)."""
    return {k: v for k, v in launches.items() if v and k != "flash_attention"}


def scan_and_host(pipe, run, frames: int, path: str, kernels, checked):
    """The path's call ``run(steps)`` under ``step_mode="host"`` and
    ``"scan"`` (the default). Host first, with no graph held: two 2-step
    calls, whose spread sets the equality gate (bit-equal runs make it
    exact, else their relative L2 is the gate), then a 30-step call. Then
    scan: 2 steps twice (the key's first call runs eagerly, the second is
    captured and replayed), then 30 steps three times (eager; capture and
    replay; replay), each gated against host's output of its length. The
    wrappers count launches when their Python runs: the eager call and the
    capturing call each count one loop, a replay none. Seconds and peak
    allocated and reserved memory of each call, the number of calls of one
    key after which scan's total is below host's, and the card's busy share
    of the denoise alone under each route. Returns the replayed output and
    a record."""
    pipe.graphs.clear()
    torch.cuda.empty_cache()
    pipe.step_mode = "host"
    e1, e2 = run(2), run(2)
    spread = rel_l2(e1, e2)
    gate = (lambda a, b: torch.equal(a, b)) if spread == 0 else (
        lambda a, b: rel_l2(a, b) <= spread)
    host = timed_call(run, STEPS)
    pipe.step_mode = "scan"
    s1, s2 = run(2), run(2)
    captured_loop(pipe, 2)
    first = timed_call(run, STEPS)
    captured_loop(pipe, 2)  # the 30-step key's first call did not capture
    capture = timed_call(run, STEPS)
    loop = captured_loop(pipe, STEPS)
    warm = timed_call(run, STEPS)
    launches, shapes = capture["launches"], capture["shapes"]
    n_even = break_even(first["s"], capture["s"], warm["s"], host["s"])
    log(f"{path} scan: the key's first call {first['s']:.2f} s (eager), the second "
        f"{capture['s']:.2f} s (capture {loop.capture_s:.2f} s, one replay, the decode), warm "
        f"calls {warm['s']:.2f} s ({frames / warm['s']:.4f} frames/s); host {host['s']:.2f} s "
        f"({frames / host['s']:.4f} frames/s); scan's total is below host's after {n_even:.2f} "
        f"calls of one key")
    log(f"{path} launches counted in the eager call: {json.dumps(first['launches'])}; in the "
        f"capturing call: {json.dumps(launches)}; captured: {json.dumps(loop.launches)}; in a "
        f"replaying call: {json.dumps(loop_only(warm['launches']))} (the decode's aside)")
    check_launches(path, launches, shapes, kernels, checked)
    if not (first["launches"] == launches == host["launches"]
            and loop_only(launches) == loop.launches and not loop_only(warm["launches"])):
        raise AssertionError(f"{path}: the eager, capturing and host calls must each count one "
                             f"loop, the capture alone that loop, and a replay none")
    log(f"{path} peak allocated / reserved GiB: host {host['peak']:.2f} / {host['reserved']:.2f} "
        f"(no graph held), scan eager {first['peak']:.2f} / {first['reserved']:.2f}, capturing "
        f"{capture['peak']:.2f} / {capture['reserved']:.2f}, warm {warm['peak']:.2f} / "
        f"{warm['reserved']:.2f} (the {STEPS}-step graph held)")
    equal = {"eager_vs_eager_2_steps": spread, "scan_eager_vs_host_2_steps": rel_l2(s1, e1),
             "scan_replay_vs_host_2_steps": rel_l2(s2, e1),
             "scan_eager_vs_host": rel_l2(first["out"], host["out"]),
             "scan_replay_vs_host": rel_l2(capture["out"], host["out"]),
             "replay_vs_replay": rel_l2(warm["out"], capture["out"])}
    log(f"{path} relative L2 (0 = bit-equal here): {json.dumps(equal)}")
    if not (gate(s1, e1) and gate(s2, e1) and gate(first["out"], host["out"])
            and gate(capture["out"], host["out"]) and torch.equal(warm["out"], capture["out"])):
        raise AssertionError(f"{path}: the scan route disagrees with the host route beyond the "
                             f"eager-vs-eager spread {spread:.3e}, or two replays differ")

    kw = dict(num_inference_steps=STEPS, guidance_scale=6.0, propagation_steps=frozenset())
    with torch.no_grad():
        scan_busy, scan_wall = busy_share(loop.graph.replay)[:2]
        host_busy, host_wall = busy_share(lambda: pipe.denoise(*loop.static, **kw))[:2]
    log(f"{path} denoise alone ({STEPS} steps), card busy / wall (profiled): scan "
        f"{scan_busy * 1e3:.1f} / {scan_wall * 1e3:.1f} ms ({scan_busy / scan_wall:.1%}), host "
        f"{host_busy * 1e3:.1f} / {host_wall * 1e3:.1f} ms ({host_busy / host_wall:.1%}); the "
        f"host route's kernel time over the scan route's wall: {host_busy / scan_wall:.1%}")
    return capture["out"], dict(
        first_call_seconds=first["s"], capture_call_seconds=capture["s"],
        capture_seconds=loop.capture_s, captured_launches=loop.launches,
        scan_seconds=warm["s"], host_seconds=host["s"], break_even_calls=n_even,
        scan_frames_per_s=frames / warm["s"], host_frames_per_s=frames / host["s"],
        peak_gib={k: dict(allocated=r["peak"], reserved=r["reserved"])
                  for k, r in (("host", host), ("scan_eager", first), ("scan_capture", capture),
                               ("scan_warm", warm))},
        rel_l2=equal, eager_rel_l2=spread,
        scan_denoise_busy_s=scan_busy, scan_denoise_wall_s=scan_wall,
        host_denoise_busy_s=host_busy, host_denoise_wall_s=host_wall,
        launches=launches, launches_by_shape=shapes, loop_launches_by_shape=host["shapes"])


def run_path1(pipe, card: str, checked):
    g = torch.Generator(device="cuda").manual_seed(3)
    image = torch.rand((1, FRAMES, LR, LR, 3), generator=g, device="cuda") * 2 - 1
    run = lambda steps: pipe("a video", image, num_inference_steps=steps, guidance_scale=6.0,
                             noise_level=120,
                             generator=torch.Generator(device="cuda").manual_seed(4))
    out, rec = scan_and_host(pipe, run, FRAMES, "path 1", PATH1_KERNELS, checked)
    check_output(out, (1, FRAMES, 4 * LR, 4 * LR, 3))
    secs = rec["scan_seconds"]
    log(f"path 1 e2e (warm, scan): {FRAMES} frames {LR}x{LR} -> {tuple(out.shape)} in "
        f"{secs:.2f} s: {FRAMES / secs:.4f} frames/s on {card}")
    same = (lambda a, b: torch.equal(a, b)) if rec["eager_rel_l2"] == 0 else (
        lambda a, b: rel_l2(a, b) <= rec["eager_rel_l2"])

    # the same call on the plain PyTorch versions (host route, as the kernel
    # route's host call), for the kernels' end-to-end effect. 30 bf16 steps
    # with CFG 6 amplify rounding chaotically, so the 30-step outputs are
    # compared as distributions; a 2-step pair shows the pointwise distance
    # before the amplification. Reported, not gated: the gates are the
    # per-kernel and the UNet checks.
    pipe.step_mode = "host"
    out2 = run(2)
    with _cuda.plain_path():
        t0 = time.time()
        ref = run(STEPS)
        torch.cuda.synchronize()
        plain_secs = time.time() - t0
        ref2 = run(2)
    log(f"e2e plain versions (host): {plain_secs:.2f} s: {FRAMES / plain_secs:.4f} frames/s "
        f"(kernels, host: {rec['host_seconds']:.2f} s); mean/std kernels "
        f"{out.mean().item():.4f}/{out.std().item():.4f}, plain "
        f"{ref.mean().item():.4f}/{ref.std().item():.4f}; 30 steps |kernels - plain| max "
        f"{(out - ref).abs().max().item():.4f} mean {(out - ref).abs().mean().item():.5f} "
        f"rel L2 {rel_l2(out, ref):.3e}; "
        f"2 steps max {(out2 - ref2).abs().max().item():.4f} mean "
        f"{(out2 - ref2).abs().mean().item():.5f} rel L2 {rel_l2(out2, ref2):.3e}")

    # Pyramid Attention Broadcast on the text cross-attentions (bench.py:159):
    # the key's first call eagerly, the second captured, the third replayed;
    # kernel 3 runs on the 7 computed steps of 30 (0, 1, 2, 8, 14, 20, 26),
    # 20 launches a forward; with a cache no attention folds its residual,
    # so every launch of kernels 1 and 3 is a delta (add_residual 0). The
    # host loop under the same config gives the reference: the cached
    # deltas, which live in the graph's pool across all 30 replayed steps,
    # must give what the eager loop gives, within the eager spread.
    pipe.step_mode = "scan"
    pipe.pab = PABConfig(kinds=("cross",))
    pab_first = timed_call(run, STEPS)
    pab_cap = timed_call(run, STEPS)
    loop = captured_loop(pipe, STEPS, pipe.pab)
    pab_warm = timed_call(run, STEPS)
    pipe.step_mode = "host"
    pab_host = timed_call(run, STEPS)
    with _cuda.plain_path():  # the plain versions' distance to their exact route (ref)
        pab_plain = run(STEPS)
    pab_secs = pab_warm["s"]
    pab_rel, plain_rel = rel_l2(pab_warm["out"], out), rel_l2(pab_plain, ref)
    pab_launches, pab_shapes = pab_cap["launches"], pab_cap["shapes"]
    residual = {k: sum(n for run_ in (pab_cap, pab_host) for shape, n in
                       _cuda_shapes(run_["shapes"], k) if shape[-1] == 1)
                for k in ("cross_attention_block", "temporal_attention_block")}
    log(f"path 1 with PABConfig(kinds=('cross',)), scan: first call {pab_first['s']:.2f} s "
        f"(eager), capturing call {pab_cap['s']:.2f} s, warm {pab_secs:.2f} s "
        f"({FRAMES / pab_secs:.4f} frames/s against {FRAMES / secs:.4f}); host "
        f"{pab_host['s']:.2f} s; captured launches {json.dumps(loop.launches)}; launches with "
        f"the residual folded {json.dumps(residual)}; replay against host rel L2 "
        f"{rel_l2(pab_cap['out'], pab_host['out']):.3e}, eager scan against host "
        f"{rel_l2(pab_first['out'], pab_host['out']):.3e}; output rel L2 against the exact "
        f"route {pab_rel:.3e}, on the plain versions {plain_rel:.3e} (approximate by design: "
        f"reported, not gated)")
    check_launches("path 1 under PAB", pab_launches, pab_shapes, PATH1_KERNELS, checked)
    if (loop.launches.get("cross_attention_block") != 20 * len(PAB_COMPUTED)
            or loop.launches.get("temporal_attention_block") != 16 * STEPS or any(residual.values())
            or pab_first["launches"] != pab_launches or pab_host["launches"] != pab_launches):
        raise AssertionError(f"path 1 under PAB: captured {loop.launches}, with the residual "
                             f"{residual}; expected {20 * len(PAB_COMPUTED)} cross-attentions, "
                             f"{16 * STEPS} temporal attention blocks, all without the residual, "
                             f"and the eager and host calls launching what the capture did")
    if not (same(pab_cap["out"], pab_host["out"]) and same(pab_first["out"], pab_host["out"])
            and torch.equal(pab_warm["out"], pab_cap["out"])):
        raise AssertionError("path 1 under PAB: the scan route disagrees with the host route "
                             "beyond the eager-vs-eager spread, or two replays differ")

    # every kind cached from step 0: step 1 of 2 broadcasts the deltas of
    # step 0; the kernels against the plain versions at the UNet's gate
    pipe.pab = PABConfig(start_step=0)
    all2 = timed_call(run, 2)
    with _cuda.plain_path():
        all2_plain = run(2)
    pipe.pab = None
    pipe.step_mode = "scan"
    all2_rel = rel_l2(all2["out"], all2_plain)
    log(f"path 1, 2 steps under PABConfig(start_step=0) (every kind broadcast at step 1): rel L2 "
        f"kernels vs plain {all2_rel:.3e} (tol {UNET_TOL}); launches {json.dumps(all2['launches'])}")
    check_launches("path 1 under PAB, every kind", all2["launches"], all2["shapes"],
                   ("temporal_attention_block", "cross_attention_block"), checked)
    if not (torch.isfinite(all2["out"]).all() and all2_rel <= UNET_TOL):
        raise AssertionError(f"path 1 under PAB: kernels disagree with the plain versions: "
                             f"{all2_rel:.3e}")
    return dict(rec, seconds=secs, plain_seconds=plain_secs, frames=FRAMES,
                frames_per_s=FRAMES / secs, kernels_vs_plain_rel_l2=rel_l2(out, ref),
                two_step_kernels_vs_plain_rel_l2=rel_l2(out2, ref2),
                pab=dict(first_call_seconds=pab_first["s"], capture_call_seconds=pab_cap["s"],
                         seconds=pab_secs, host_seconds=pab_host["s"],
                         frames_per_s=FRAMES / pab_secs, captured_launches=loop.launches,
                         launches=pab_launches, rel_l2_vs_exact=pab_rel,
                         plain_rel_l2_vs_exact=plain_rel,
                         scan_vs_host_rel_l2=rel_l2(pab_cap["out"], pab_host["out"]),
                         every_kind_two_step_kernels_vs_plain_rel_l2=all2_rel))


def _cuda_shapes(shapes, kernel):
    """(shape tuple, launches) of one kernel from :func:`launch_shapes`."""
    return [(tuple(json.loads(k)), n) for k, n in shapes.get(kernel, {}).items()]


def run_path2(pipe, card: str, checked):
    """The README's video-VAE configuration on a short clip: every temporal
    attention of the UNet goes through the fused temporal attention (T = 5
    fits no row tile of the whole-block kernel)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    image = torch.rand((1, FRAMES2, H2, W2, 3), generator=g, device="cuda") * 2 - 1
    run = lambda steps: pipe("a video", image, num_inference_steps=steps, guidance_scale=6.0,
                             noise_level=120, w_lr=1.0,
                             generator=torch.Generator(device="cuda").manual_seed(4))
    out, rec = scan_and_host(pipe, run, FRAMES2, "path 2", PATH2_KERNELS, checked)
    check_output(out, (1, FRAMES2, 4 * H2, 4 * W2, 3))
    captured = rec["captured_launches"]
    if captured.get("fused_temporal_attention") != 16 * STEPS or "temporal_attention_block" in \
            captured:
        raise AssertionError("path 2 must run its 16 temporal attentions per step through the "
                             "fused temporal attention and none through the whole-block kernel")

    # end to end with the colour fix (warm, scan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = run(STEPS)
    torch.cuda.synchronize()
    pipe_secs = time.time() - t0
    fixed = apply_color_fix("Wavelet", out[0], image[0])[None]
    torch.cuda.synchronize()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    fps = FRAMES2 / secs
    log(f"path 2 e2e (warm, scan): {FRAMES2} frames {H2}x{W2} -> {tuple(fixed.shape)} in "
        f"{secs:.2f} s (pipeline {pipe_secs:.2f} s, colour fix {secs - pipe_secs:.2f} s): "
        f"{fps:.4f} frames/s on {card}")
    log(f"max_memory_allocated={peak / 2**30:.2f} GiB, max_memory_reserved="
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB (the graph held)")
    log(f"colour-fixed output finite={bool(torch.isfinite(fixed).all())} "
        f"min={fixed.min().item():.4f} max={fixed.max().item():.4f}")
    if fixed.shape != out.shape or not torch.isfinite(fixed).all():
        raise AssertionError("colour-fixed output has the wrong shape or is not finite")

    # the same call and colour fix on the plain PyTorch versions (host route),
    # for the kernels' end-to-end effect (reported, not gated, as on path 1)
    pipe.step_mode = "host"
    with _cuda.plain_path():
        torch.cuda.synchronize()
        t0 = time.time()
        ref = run(STEPS)
        ref_fixed = apply_color_fix("Wavelet", ref[0], image[0])[None]
        torch.cuda.synchronize()
        plain_secs = time.time() - t0
    log(f"path 2 e2e plain versions (host): {plain_secs:.2f} s: {FRAMES2 / plain_secs:.4f} "
        f"frames/s; mean/std kernels {fixed.mean().item():.4f}/{fixed.std().item():.4f}, plain "
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
    fp32_decode = fp32_operand_decode(pipe, lat, image, checked)

    # a 2-step pair against the plain versions (host route; reported, not gated)
    with _cuda.plain_path():
        ref2 = run(2)
    out2 = run(2)
    pipe.step_mode = "scan"
    log(f"path 2, 2 steps: |kernels - plain| max {(out2 - ref2).abs().max().item():.4f} mean "
        f"{(out2 - ref2).abs().mean().item():.5f}")

    # 2 steps (scan: each call the key's first, so eager; every move of a
    # module drops the held graph) with the UNet and VAE weights resident,
    # then offloaded to the host between their stages: the same output, bit
    # for bit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res2 = run(2)
    peak2 = torch.cuda.max_memory_allocated()
    pipe.enable_model_offload()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    off2 = run(2)
    torch.cuda.synchronize()
    off_secs = time.time() - t0
    off_peak = torch.cuda.max_memory_allocated()
    pipe.enable_model_offload(False)
    log(f"path 2, 2 steps with enable_model_offload(): {off_secs:.2f} s, peak "
        f"{off_peak / 2**30:.2f} GiB against {peak2 / 2**30:.2f} GiB resident; equal to the "
        f"resident call: {torch.equal(off2, res2)}")
    if not torch.equal(off2, res2):
        raise AssertionError(f"the offloaded call differs from the resident one: max |diff| "
                             f"{(off2 - res2).abs().max().item():.3e}")
    return dict(rec, seconds=secs, pipeline_seconds=pipe_secs, plain_seconds=plain_secs,
                decode_seconds=decode_secs, decode_rel_l2=dec_rel, fp32_decode=fp32_decode,
                extra_launches=fp32_decode["launches"],
                frames=FRAMES2, frames_per_s=fps,
                peak_gib=peak / 2**30, two_step_peak_gib=peak2 / 2**30,
                offload_two_step_peak_gib=off_peak / 2**30, offload_two_step_seconds=off_secs)


def fp32_operand_decode(pipe, lat, image, checked):
    """Path 2's decode with fp32 q, k and v in the mid-block attention (the
    CLI's ``--decode_attn fp32``): the fp32 flash kernel, one launch a
    chunk, against the plain decode at the decode's gate."""
    blocks = [m for m in pipe.m.vae.modules() if isinstance(m, SpatialAttentionBlock)]
    for m in blocks:
        m.fp32_operands = True
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.time()
            dec = pipe.decode_latents(lat, image, 1.0)
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches, shapes = dict(_cuda.LAUNCHES), launch_shapes()
            with _cuda.plain_path():
                ref = pipe.decode_latents(lat, image, 1.0)
    finally:
        for m in blocks:
            m.fp32_operands = False
    rel = rel_l2(dec, ref)
    log(f"path 2 decode alone with fp32 attention operands (--decode_attn fp32): {secs:.2f} s; "
        f"rel L2 kernels vs plain = {rel:.3e} (tol {DECODE_TOL}), max |diff| "
        f"{(dec - ref).abs().max().item():.3e}")
    check_launches("path 2's fp32-operand decode", launches, shapes, ("flash_attention_f32",),
                   checked)
    per_chunk = sum(isinstance(m, SpatialAttentionBlock) for m in pipe.m.vae.decoder.modules())
    predicted = {"flash_attention_f32": per_chunk * len(chunk_starts(lat.shape[1],
                                                                     pipe.DECODE_CHUNK))}
    if {k: v for k, v in launches.items() if v} != predicted:
        raise AssertionError(f"the fp32-operand decode launched {launches}; predicted the fp32 "
                             f"flash kernel once per chunk and attention block: {predicted}")
    if not (torch.isfinite(dec).all() and rel <= DECODE_TOL):
        raise AssertionError(f"the fp32-operand decode disagrees with the plain decode: {rel:.3e}")
    return dict(seconds=secs, rel_l2=rel, launches=launches, launches_by_shape=shapes)


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def mask_shares(flows_f, flows_b):
    """Per sweep, the share of pixels the consistency check keeps, over the
    frames (the backward sweep checks the forward flow against the backward
    one, the forward sweep the reverse), at the latent size (= the LR size)."""
    fwd = [fb_consistency_check(flows_f[:, i], flows_b[:, i], 1e-3, 0.05).mean().item()
           for i in range(flows_f.shape[1])]
    bwd = [fb_consistency_check(flows_b[:, i], flows_f[:, i], 1e-3, 0.05).mean().item()
           for i in range(flows_f.shape[1])]
    return dict(backward_sweep=float(np.mean(fwd)), forward_sweep=float(np.mean(bwd)))


def run_path3(card: str, checked):
    """The headline command with ``-p 24,26,28``: RAFT's flows on the card
    (against the CPU), the propagation (against the CPU), the pipeline with
    propagation and the colour fix, then the encoder against its plain run."""
    t0 = time.time()
    pipe = load_pipeline(random_init=True, use_video_vae=True, device="cuda")
    raft = load_raft(None, device="cuda")
    torch.cuda.synchronize()
    log(f"built the pipeline (load_pipeline, video VAE) and RAFT in {time.time() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(3)
    image = torch.rand((1, FRAMES2, H2, W2, 3), generator=g, device="cuda") * 2 - 1

    # RAFT, cold then warm, and the same RAFT on the CPU
    torch.cuda.synchronize()
    t0 = time.time()
    compute_bidirectional_flows(raft, image)
    torch.cuda.synchronize()
    raft_cold = time.time() - t0
    t0 = time.time()
    flows = compute_bidirectional_flows(raft, image)
    torch.cuda.synchronize()
    raft_secs = time.time() - t0
    cpu_raft = RaftRunner(copy.deepcopy(raft.model).cpu(), raft.iters)
    t0 = time.time()
    cpu_flows = compute_bidirectional_flows(cpu_raft, image.cpu())
    cpu_secs = time.time() - t0
    flow_rel = max(rel_l2(f.cpu(), c) for f, c in zip(flows, cpu_flows))
    shares = mask_shares(*flows)
    log(f"RAFT flows {tuple(flows[0].shape)} x2 ({FRAMES2 - 1} + {FRAMES2 - 1} pairs, "
        f"{raft.iters} iterations, fp32): {raft_secs:.3f} s warm, {raft_cold:.3f} s cold "
        f"(CPU {cpu_secs:.2f} s); rel L2 card vs CPU = {flow_rel:.3e} (tol {FLOW_TOL}); "
        f"|flow| mean {flows[0].abs().mean().item():.3f} max {flows[0].abs().max().item():.3f}; "
        f"consistency mask keeps {json.dumps(shares)}")
    if not (all(torch.isfinite(f).all() for f in flows) and flow_rel <= FLOW_TOL):
        raise AssertionError(f"RAFT on the card disagrees with the CPU: {flow_rel:.3e}")

    # propagation of one x̂0 along RAFT's flows, and along a consistent pair
    # that moves it: a whole-pixel shift (2, 1) plus a smooth part under
    # 0.05 px, backward = -forward, so that no mask decision and no nearest
    # rounding lies within rounding error of its boundary (a sample on a
    # half pixel can round one way on the card and the other on the CPU)
    x0 = torch.randn((1, FRAMES2, H2, W2, 4), generator=g, device="cuda")
    shift = flows[0].new_tensor([2.0, 1.0]) + 0.05 * torch.tanh(flows[0])
    prop_err = {}
    for name, (ff, fb) in (("raft", flows), ("shift", (shift, -shift))):
        out = propagate_latents(x0, ff, fb)
        ref = propagate_latents(x0.cpu(), ff.cpu(), fb.cpu())
        prop_err[name] = (out.cpu() - ref).abs().max().item()
        log(f"propagate_latents ({name} flows, mask keeps {json.dumps(mask_shares(ff, fb))}): "
            f"max |card - CPU| = {prop_err[name]:.3e} (tol {PROP_TOL}), "
            f"|out - x0| max {(out - x0).abs().max().item():.3f}")
        if not (torch.isfinite(out).all() and prop_err[name] <= PROP_TOL):
            raise AssertionError(f"propagation on the card disagrees with the CPU: "
                                 f"{prop_err[name]:.3e}")
    # (RAFT flow, -RAFT flow), reported, not gated: the decisions that differ
    # between the card and the CPU, and what they do to the propagation
    ff = flows[0]
    flips = ties = 0
    for a, b in ((ff, -ff), (-ff, ff)):
        for i in range(ff.shape[1]):
            flips += int((fb_consistency_check(a[:, i], b[:, i], 1e-3, 0.05).cpu()
                          != fb_consistency_check(a[:, i].cpu(), b[:, i].cpu(), 1e-3, 0.05)).sum())
            near = (flow_warp(x0[:, i], a[:, i], "nearest").cpu()
                    - flow_warp(x0[:, i].cpu(), a[:, i].cpu(), "nearest"))
            ties += int((near.abs() > PROP_TOL).any(-1).sum())
    diff = (propagate_latents(x0, ff, -ff).cpu() - propagate_latents(x0.cpu(), ff.cpu(), -ff.cpu()))
    log(f"(RAFT flow, -RAFT flow), reported, not gated: of {2 * ff[..., 0].numel()} each, {flips} "
        f"mask decisions and {ties} nearest samples differ between the card and the CPU; "
        f"propagation max |card - CPU| {diff.abs().max().item():.3e}, "
        f"{int((diff.abs() > PROP_TOL).sum())} of {diff.numel()} values beyond {PROP_TOL}")

    # end to end with the flows, propagation at steps 24, 26, 28, and the
    # colour fix ("scan", the propagation inside the graph): the key's first
    # call (eager), the capturing call (each counts one loop's launches),
    # then a warm call (one replay)
    e2e = lambda: pipe("a video", image, num_inference_steps=STEPS, guidance_scale=6.0,
                       noise_level=120, w_lr=1.0, flows_bi=flows, propagation_steps=PROP_STEPS,
                       generator=torch.Generator(device="cuda").manual_seed(4))
    eager = timed_call(e2e)
    first = timed_call(e2e)
    first_secs = first["s"]
    launches, shapes = first["launches"], first["shapes"]
    captured = captured_loop(pipe, STEPS).launches
    if eager["launches"] != launches or not torch.equal(eager["out"], first["out"]):
        raise AssertionError("path 3: the eager call and the capturing call differ in launches "
                             "or output")
    first = first["out"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = e2e()
    fixed = apply_color_fix("Wavelet", out[0], image[0])[None]
    torch.cuda.synchronize()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    fps, fps_raft = FRAMES2 / secs, FRAMES2 / (secs + raft_secs)
    log(f"path 3 e2e (warm, scan): {FRAMES2} frames {H2}x{W2} -> {tuple(fixed.shape)}, "
        f"propagation at steps {pipe.propagated_steps}: {secs:.2f} s ({fps:.4f} frames/s), with "
        f"RAFT {secs + raft_secs:.2f} s ({fps_raft:.4f} frames/s) on {card}; the key's first "
        f"call {eager['s']:.2f} s (eager), the capturing call {first_secs:.2f} s, captured "
        f"launches {json.dumps(captured)}")
    log(f"max_memory_allocated={peak / 2**30:.2f} GiB, max_memory_reserved="
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB (the graph held)")
    check_output(out, (1, FRAMES2, 4 * H2, 4 * W2, 3))
    if fixed.shape != out.shape or not torch.isfinite(fixed).all() or not torch.equal(out, first):
        raise AssertionError("colour-fixed output has the wrong shape or is not finite, or the "
                             "replay differs from the capturing call")
    if pipe.propagated_steps != PROP_STEPS:
        raise AssertionError(f"propagation ran at steps {pipe.propagated_steps}, not {PROP_STEPS}")
    check_launches("path 3", launches, shapes, PATH2_KERNELS, checked)
    if (captured.get("fused_temporal_attention") != 16 * STEPS
            or launches["fused_temporal_attention"] != 16 * STEPS
            or launches["temporal_attention_block"]):
        raise AssertionError("path 3 must run its 16 temporal attentions per step through the "
                             "fused temporal attention and none through the whole-block kernel")

    # the encoder on 3 output frames, with the kernels against the plain versions
    frames = out[:, :3].contiguous()
    with torch.no_grad():
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        moments = pipe.m.vae.encode_moments(frames)
        torch.cuda.synchronize()
        encode_secs = time.time() - t0
        enc_launches, enc_shapes = dict(_cuda.LAUNCHES), launch_shapes()
        with _cuda.plain_path():
            moments_ref = pipe.m.vae.encode_moments(frames)
    enc_rel = rel_l2(moments, moments_ref)
    log(f"encode_moments {tuple(frames.shape)} -> {tuple(moments.shape)}: {encode_secs:.3f} s; "
        f"rel L2 kernels vs plain = {enc_rel:.3e} (tol {ENCODE_TOL})")
    check_launches("path 3 encoder", enc_launches, enc_shapes, ("flash_attention",), checked)
    if not (torch.isfinite(moments).all() and enc_rel <= ENCODE_TOL):
        raise AssertionError(f"the encoder with kernels disagrees with the plain encoder: "
                             f"{enc_rel:.3e}")
    return dict(launches=launches, launches_by_shape=shapes, seconds=secs,
                raft_seconds=raft_secs, raft_cold_seconds=raft_cold, raft_cpu_seconds=cpu_secs,
                flow_rel_l2=flow_rel, mask_share=shares, propagation_max_err=prop_err,
                propagated_steps=list(pipe.propagated_steps), frames=FRAMES2,
                first_call_seconds=eager["s"], capture_call_seconds=first_secs,
                captured_launches=captured,
                frames_per_s=fps, frames_per_s_with_raft=fps_raft, peak_gib=peak / 2**30,
                encode_seconds=encode_secs, encode_rel_l2=enc_rel,
                encode_launches=enc_launches)


class CallRecorder:
    """The pipeline as the CLI sees it, recording each call's batch and the
    steps it propagated at. With ``tile_noise`` set to a seed, every tile
    gets noise of its own (the ``latents``/``lr_noise`` seams, drawn from
    the seed plus the tile's index in the run), whatever the calls' batches:
    with one generator per call, as the JAX CLI's one key, the noise of a
    tile depends on the batch it is drawn in."""

    def __init__(self, pipe):
        object.__setattr__(self, "pipe", pipe)
        object.__setattr__(self, "calls", [])
        object.__setattr__(self, "tile_noise", None)
        object.__setattr__(self, "tiles", 0)

    def __call__(self, prompt, image, *args, **kwargs):
        if self.tile_noise is not None:
            b, t, h, w, _ = image.shape
            draws = []
            for j in range(b):
                seed = self.tile_noise + self.tiles + j
                g = torch.Generator(device=image.device).manual_seed(seed)
                draws.append((torch.randn((1, t, h, w, 4), generator=g, device=image.device),
                              torch.randn((1, t, h, w, 3), generator=g, device=image.device)))
            object.__setattr__(self, "tiles", self.tiles + b)
            kwargs["latents"] = torch.cat([d[0] for d in draws])
            kwargs["lr_noise"] = torch.cat([d[1] for d in draws])
        out = self.pipe(prompt, image, *args, **kwargs)
        self.calls.append((image.shape[0], self.pipe.propagated_steps))
        return out

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __setattr__(self, name, value):
        setattr(self.pipe, name, value)


def synthetic_clip(seed: int, t: int, h: int, w: int) -> np.ndarray:
    """(t, h, w, 3) uint8: a field of random 8x8 blocks panning by (1, 2) px
    a frame, so that RAFT sees consistent motion."""
    rng = np.random.default_rng(seed)
    field = rng.integers(0, 256, ((h + t) // 8 + 1, (w + 2 * t) // 8 + 1, 3), dtype=np.uint8)
    field = np.repeat(np.repeat(field, 8, axis=0), 8, axis=1)
    return np.ascontiguousarray(np.stack([field[i:i + h, 2 * i:2 * i + w] for i in range(t)]))


# path 4's launches: 2 UNet calls a step (windows 0 and 6, window_group 1)
# of path 1's per-forward counts (16, 16, 20, 16; 4 rows at T = 8), and the
# decode's 5 chunks (4 of 3 frames, 1 of 2) of the two tiles; the fp32 pair's
# (the clip's first 8 frames): flash alone (the UNet's kernels take bf16), 3
# chunks of each of 3 calls
P4_FORWARDS = 2 * STEPS
P4_LAUNCHES = {"temporal_attention_block": 16 * P4_FORWARDS,
               "fused_temporal_resblock": 16 * P4_FORWARDS,
               "cross_attention_block": 20 * P4_FORWARDS,
               "fused_feedforward": 16 * P4_FORWARDS, "flash_attention": 5}
P4_FP32_LAUNCHES = {"flash_attention": 9}
# path 4's short clip: its first 8 frames, one window a step, 3 decode chunks
FRAMES4S = 8
P4S_LAUNCHES = dict(P4_LAUNCHES, **{k: v // 2 for k, v in P4_LAUNCHES.items()
                                    if k != "flash_attention"}, flash_attention=3)


class StageClock:
    """Seconds and peak device memory of each stage of one run, a stage
    ending where :meth:`end` is called after a sync: RAFT and the colour
    fix through :meth:`timed` wrappers, the denoise and the decode at the
    pipeline's progress ticks; what lies between them is "rest"."""

    def __init__(self):
        self.mark = time.time()
        self.seconds, self.peak = {}, {}

    def end(self, stage):
        now = time.time()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self.mark
        self.peak[stage] = max(self.peak.get(stage, 0), torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        self.mark = now

    def tick(self, stage, done, total):
        self.end(stage)

    def timed(self, fn, stage):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            self.end("rest")
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.end(stage)
            return out
        return run


@contextlib.contextmanager
def patched(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def run_path4(card: str, checked):
    """The port CLI's per-clip step on the card: the headline command with
    two batched 128x192 tiles, in memory."""
    args = cli.build_parser().parse_args(P4_ARGV)
    t0 = time.time()
    pipe, raft = cli.load_models(args, torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"built the pipeline and RAFT the CLI's way (cli.load_models: video VAE, "
        f"{pipe.m.vae.post_quant_conv.weight.dtype} decode) in {time.time() - t0:.1f} s")
    t0 = time.time()
    native_frameproc.lib()  # its build at first use is set-up, as the kernels' is
    log(f"built the frame conversions (csrc/frameproc.cpp) in {time.time() - t0:.1f} s")
    frames_u8 = synthetic_clip(6, FRAMES4, H4, W4)
    recorder = CallRecorder(pipe)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    clock = StageClock()
    t0 = clock.mark
    with patched(cli, compute_bidirectional_flows=clock.timed(cli.compute_bidirectional_flows,
                                                              "raft"),
                 apply_color_fix=clock.timed(cli.apply_color_fix, "color_fix")):
        out = cli.process_clip(recorder, raft, frames_u8, args, progress_cb=clock.tick)
    clock.end("rest")
    secs = clock.mark - t0
    launches, shapes = dict(_cuda.LAUNCHES), launch_shapes()
    stages, stage_peak = clock.seconds, {k: v / 2**30 for k, v in clock.peak.items()}
    peak = max(clock.peak.values())
    fps = FRAMES4 / secs
    log(f"path 4 e2e (cli.process_clip): {FRAMES4} frames {H4}x{W4} uint8 -> {out.shape} "
        f"{out.dtype} in {secs:.2f} s: {fps:.4f} frames/s on {card}; stages (s): "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})} (rest: frame "
        f"conversions, host copy, paste)")
    log(f"max_memory_allocated={peak / 2**30:.2f} GiB; by stage (GiB): "
        f"{json.dumps({k: round(v, 2) for k, v in stage_peak.items()})}")
    log(f"tile calls (batch, propagated steps): {recorder.calls}")
    if out.shape != (FRAMES4, 4 * H4, 4 * W4, 3) or out.dtype != np.uint8:
        raise AssertionError(f"path 4 output {out.shape} {out.dtype}, expected "
                             f"{(FRAMES4, 4 * H4, 4 * W4, 3)} uint8")
    if recorder.calls != [(2, PROP_STEPS)]:
        raise AssertionError(f"path 4 must make one call of both tiles that propagates at "
                             f"{PROP_STEPS}: {recorder.calls}")
    check_launches("path 4", launches, shapes, PATH1_KERNELS, checked)
    unexpected = {k: (v, P4_LAUNCHES.get(k, 0)) for k, v in launches.items()
                  if v != P4_LAUNCHES.get(k, 0)}
    if unexpected:
        raise AssertionError(f"path 4 launches (got, predicted): {unexpected}")
    calls = recorder.calls
    del recorder
    short = run_short_clip(pipe, raft, frames_u8[:FRAMES4S], card, checked)
    del pipe
    torch.cuda.empty_cache()

    # 2 steps on the clip's first 8 frames, both tiles in one call against
    # one tile per call, each tile with the same noise in both, in float
    # before the uint8 conversion, in fp32, step by step: the batching is
    # exact, so the two agree to float32 rounding (in bf16 any other
    # summation order, batching or the plain versions, moves this output by
    # ~2.5e-2: CFG 6 amplifies a bf16 rounding ~11x)
    frames = video_io.to_model_range(frames_u8)

    def two_steps(p, tile_batch):
        rec = CallRecorder(p)
        object.__setattr__(rec, "tile_noise", 7)
        a = cli.build_parser().parse_args(P4_ARGV + ["-s", "2", "--tile_batch", str(tile_batch)])
        out = cli.upscale_clip(rec, raft, frames[:FRAMES4S], a)
        if [batch for batch, _ in rec.calls] != [tile_batch] * (2 // tile_batch):
            raise AssertionError(f"--tile_batch {tile_batch}: calls {rec.calls}")
        return out

    pipe32 = load_pipeline(random_init=True, use_video_vae=True, dtype=torch.float32,
                           device="cuda")
    pipe32.step_mode = "host"
    _cuda.reset_launch_counts()
    fp32 = {tb: two_steps(pipe32, tb) for tb in (1, 2)}
    launches32, shapes32 = dict(_cuda.LAUNCHES), launch_shapes()
    del pipe32
    check_launches("path 4's fp32 tile pair", launches32, shapes32, (), checked)
    wrong = {k: (v, P4_FP32_LAUNCHES.get(k, 0)) for k, v in launches32.items()
             if v != P4_FP32_LAUNCHES.get(k, 0)}
    if wrong:
        raise AssertionError(f"path 4's fp32 pair launches (got, predicted): {wrong}")
    tile_rel32 = rel_l2(fp32[2], fp32[1])
    log(f"2 steps (fp32), --tile_batch 2 against 1: rel L2 {tile_rel32:.3e} "
        f"(tol {TILE_TOL}), max |diff| {(fp32[2] - fp32[1]).abs().max().item():.3e}")
    if not (torch.isfinite(fp32[2]).all() and tile_rel32 <= TILE_TOL):
        raise AssertionError(f"batched tiles disagree with one tile per call: {tile_rel32:.3e}")

    # the native frame conversions against their plain versions, bit for bit,
    # on the clip, its model-range frames and the 2-step output
    out2 = fp32[2].cpu().numpy()
    conv = {"normalize_u8": (native_frameproc.normalize_u8(frames_u8),
                             native_frameproc.normalize_u8_plain(frames_u8)),
            "denormalize_f32": (native_frameproc.denormalize_f32(out2),
                                native_frameproc.denormalize_f32_plain(out2)),
            "area_downsample4": (native_frameproc.area_downsample4(frames),
                                 native_frameproc.area_downsample4_plain(frames))}
    equal = {k: bool(np.array_equal(a, b)) for k, (a, b) in conv.items()}
    log(f"native frameproc equal to its plain versions: {json.dumps(equal)}")
    if not all(equal.values()):
        raise AssertionError(f"native frame conversions differ from their plain versions: {equal}")
    return dict(launches=launches, launches_by_shape=shapes, seconds=secs, stage_seconds=stages,
                stage_peak_gib=stage_peak, frames=FRAMES4, frames_per_s=fps,
                peak_gib=peak / 2**30, tile_calls=[list(c) for c in calls],
                tile_batch_fp32_rel_l2=tile_rel32, tile_batch_fp32_launches=launches32,
                frameproc_equal=equal, short_clip=short)


def printable(text: str) -> str:
    return "".join(c if c.isprintable() else "?" for c in text)


def run_short_clip(pipe, raft, frames_u8, card: str, checked):
    """An 8-frame clip through ``cli.process_clip`` with path 4's flags (one
    call of its two tiles, under the "scan" the CLI keeps for clips of 8
    frames or fewer), as a run of such clips calls it: the first call runs
    the loop eagerly, the second captures and replays it, the third
    replays; against the host loop (seconds, launches, outputs equal), and
    the number of calls of one key after which scan's total is below
    host's. Then the same clip with the captioner at LLaVA-1.5-13B widths
    (bf16, random weights) on the card beside the pipeline, the graph held:
    the CLI's peak memory with both."""
    args = cli.build_parser().parse_args(P4_ARGV)
    pipe.step_mode, pipe.window_group = "scan", 0  # what the CLI leaves for short clips
    pipe.graphs.clear()
    torch.cuda.empty_cache()
    clip = lambda captioner=None: cli.process_clip(pipe, raft, frames_u8, args, captioner)
    first, capture, warm = (timed_call(clip) for _ in range(3))
    loop = captured_loop(pipe, STEPS)
    pipe.step_mode = "host"
    host = timed_call(clip)
    pipe.step_mode = "scan"
    t = len(frames_u8)
    n_even = break_even(first["s"], capture["s"], warm["s"], host["s"])
    log(f"path 4, {t} frames (cli.process_clip, scan): first call {first['s']:.2f} s (eager), "
        f"second {capture['s']:.2f} s (capture {loop.capture_s:.2f} s), third {warm['s']:.2f} s "
        f"({t / warm['s']:.4f} frames/s); host {host['s']:.2f} s ({t / host['s']:.4f} frames/s) "
        f"on {card}; scan's total is below host's after {n_even:.2f} calls of one key; peak "
        f"allocated / reserved GiB: host {host['peak']:.2f} / {host['reserved']:.2f}, scan "
        f"warm {warm['peak']:.2f} / {warm['reserved']:.2f}")
    log(f"path 4, {t} frames: launches of the eager call {json.dumps(first['launches'])}, "
        f"captured {json.dumps(loop.launches)}")
    check_launches(f"path 4, {t} frames", first["launches"], first["shapes"], PATH1_KERNELS,
                   checked)
    counts = [r["launches"] for r in (first, capture, host)]
    if (any({k: v for k, v in c.items() if v} != P4S_LAUNCHES for c in counts)
            or loop_only(warm["launches"])):
        raise AssertionError(f"path 4, {t} frames: launches (eager, capturing, host) {counts}, "
                             f"predicted {P4S_LAUNCHES} each; a replay {warm['launches']}")
    if not all(np.array_equal(r["out"], host["out"]) for r in (first, capture, warm)):
        raise AssertionError(f"path 4, {t} frames: a scan call's output differs from host's")

    model = random_module(lambda: LlavaModel(LlavaConfig()), 0)
    cap = LlavaCaptioner(model, tokenizer=ByteTokenizer(), max_new_tokens=64)
    with_cap = timed_call(clip, lambda frame: printable(cap.caption(frame)))
    del model, cap
    torch.cuda.empty_cache()
    log(f"path 4, {t} frames with the 13B captioner on the card (bf16): {with_cap['s']:.2f} s, "
        f"peak allocated / reserved {with_cap['peak']:.2f} / {with_cap['reserved']:.2f} GiB "
        f"against {warm['peak']:.2f} / {warm['reserved']:.2f} GiB without it")
    return dict(frames=t, first_call_seconds=first["s"], capture_call_seconds=capture["s"],
                capture_seconds=loop.capture_s, scan_seconds=warm["s"], host_seconds=host["s"],
                break_even_calls=n_even, launches=first["launches"],
                captured_launches=loop.launches,
                peak_gib={k: dict(allocated=r["peak"], reserved=r["reserved"])
                          for k, r in (("host", host), ("scan_warm", warm),
                                       ("with_captioner", with_cap))},
                with_captioner_seconds=with_cap["s"])


class ByteTokenizer:
    """The smoke's stand-in for the LLaMA tokenizer (not in the repository):
    BOS 1, then one id per UTF-8 byte (3 + byte); ids decode to bytes modulo
    256 (random weights pick any of the 32,000)."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": ([1] if add_special_tokens else []) + [3 + c for c in text.encode()]}

    def decode(self, ids, skip_special_tokens=True):
        return bytes((i - 3) % 256 for i in ids if i >= 3).decode(errors="replace")


def random_module(build, seed: int):
    """``build()`` made on ``meta``, placed on the card in bf16 and filled
    with PyTorch's initialisers from a seeded generator on the card."""
    with torch.device("meta"):
        m = build()
    m = m.to(torch.bfloat16).to_empty(device="cuda")
    return init_random_(m, torch.Generator(device="cuda").manual_seed(seed)).eval()


def decode_bytes(model) -> int:
    """Bytes a decode step reads from the decoder's weights: every layer,
    the final norm and the output projection (one embedding row aside)."""
    body = model.model if hasattr(model, "model") else model.transformer
    parts = [body.layers if hasattr(body, "layers") else body.blocks,
             body.norm if hasattr(body, "norm") else body.norm_f,
             getattr(model, "lm_head", None) or body.wte]
    return sum(quant.module_nbytes(m) for m in parts)


@torch.no_grad()
def incremental_check(model, embeds, name: str, n_dec: int = 8):
    """The last-token logits of one prefill of ``embeds`` (1, S, C) against a
    prefill of S - n_dec, then n_dec single-token steps on the cache."""
    s = embeds.shape[1]
    full, _ = model.prefill(embeds, s) if hasattr(model, "prefill") else prefill_lm(model, embeds, s)
    last, kv = (model.prefill(embeds[:, :s - n_dec], s) if hasattr(model, "prefill")
                else prefill_lm(model, embeds[:, :s - n_dec], s))
    for i in range(s - n_dec, s):
        logits, kv = model(embeds[:, i:i + 1], torch.full((1,), i, device="cuda"), kv, i,
                           decode_step_mask(i, s, "cuda"))
        last = logits[:, -1]
    rel = rel_l2(last, full)
    log(f"{name}: {n_dec} single-token steps after a prefill of {s - n_dec} against one prefill "
        f"of {s}: last logits rel L2 {rel:.3e} (tol {DECODE_STEP_TOL})")
    if not (torch.isfinite(last).all() and rel <= DECODE_STEP_TOL):
        raise AssertionError(f"{name}: incremental decoding disagrees with the prefill: {rel:.3e}")
    return rel


def prefill_lm(lm, embeds, max_len: int):
    """A causal LM's prefill into a fresh cache (``LlavaModel.prefill``
    without the vision config)."""
    cfg = lm.config
    n, hkv, d = cfg.n_layers, (1 if cfg.multiquery else cfg.n_heads), cfg.head_dim
    s = embeds.shape[1]
    kv = torch.zeros((n, 2, 1, hkv, max_len, d), dtype=embeds.dtype, device="cuda")
    logits, kv = lm(embeds, torch.arange(s, device="cuda"), kv, 0,
                    causal_prefill_mask(s, max_len, "cuda"))
    return logits[:, -1], kv


@torch.no_grad()
def decode_ms(model, embeds, steps: int = 32):
    """ms per single-token decode step (CUDA events over ``steps`` steps
    issued from the host) after a prefill of ``embeds``, and the step's bound:
    the decoder's weight bytes plus the live KV cache over the card's rate."""
    s = embeds.shape[1]
    logits, kv = model.prefill(embeds, s + steps + 1)
    token = logits.argmax(-1)
    logits, kv = model.decode_one(token, kv, s)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        logits, kv = model.decode_one(logits.argmax(-1), kv, s + 1 + i)
    end.record()
    torch.cuda.synchronize()
    n, hkv, d = model.llava_config.lm_dims
    kv_bytes = n * 2 * hkv * (s + 1 + steps / 2) * d * 2  # the live positions, on average
    return start.elapsed_time(end) / steps, (decode_bytes(model) + kv_bytes) / PEAK_BYTES * 1e3


def run_path5(card: str):
    """The captioner at the released LLaVA-1.5-13B widths on seeded random
    weights: the incremental-decode check, a caption of path 4's frame 0
    (greedy and top-p), the stage times against their bounds; then the int8
    weights of the same seed; then MPT at MPTConfig()'s widths. Returns the
    bf16 captioner (its model in host memory) and the record."""
    cfg = LlavaConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = random_module(lambda: LlavaModel(cfg), 0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    bf16_bytes = quant.module_nbytes(model)
    log(f"LLaVA ({cfg.vision.num_hidden_layers}-layer CLIP ViT-L/14-{cfg.vision.image_size}, "
        f"LLaMA {cfg.text.hidden_size} x {cfg.text.num_hidden_layers} x "
        f"{cfg.text.num_attention_heads} heads, vocab {cfg.text.vocab_size}): {n_params / 1e9:.2f} "
        f"B parameters, {bf16_bytes / 1e9:.2f} GB in bf16, drawn on the card in "
        f"{time.time() - t0:.1f} s")
    cap = LlavaCaptioner(model, tokenizer=ByteTokenizer(), max_new_tokens=64)
    frame = synthetic_clip(6, FRAMES4, H4, W4)[0]
    resized = captioner._resize_short_side(frame)  # the CLI's preprocessing, then caption()'s
    pixels = torch.as_tensor(preprocess_image(resized, cfg.vision.image_size), device="cuda")[None]
    ids, pos = build_caption_prompt(cap.tokenizer)
    with torch.no_grad():
        embeds = model.splice(torch.as_tensor(ids, device="cuda")[None],
                              model.encode_image(pixels), pos)
        prompt_logits = model.prefill(embeds, embeds.shape[1])[0]
    inc = incremental_check(model, embeds, "LLaVA-LLaMA")
    with torch.no_grad():
        vision_ms = cuda_ms(lambda: model.vision(pixels), reps=5)
        encode_ms = cuda_ms(lambda: model.encode_image(pixels), reps=5)
        prefill_ms = cuda_ms(lambda: model.prefill(embeds, embeds.shape[1] + 64), reps=3)
    step_ms, step_bound = decode_ms(model, embeds)
    captions = {}
    for name, temperature in (("greedy", 0.0), ("top_p", 0.2)):
        cap.temperature = temperature
        torch.cuda.synchronize()
        t0 = time.time()
        captions[name] = (cap.caption(resized), time.time() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"caption of path 4's frame 0 ({frame.shape} -> {resized.shape} -> {cfg.vision.image_size}"
        f"^2, prompt {embeds.shape[1]} tokens: {len(ids) - 1} text + "
        f"{embeds.shape[1] - len(ids) + 1} patches): greedy {captions['greedy'][1]:.2f} s, top-p "
        f"(T 0.2, p 0.7) {captions['top_p'][1]:.2f} s for 64 new tokens; texts (random weights, "
        f"byte tokenizer): {json.dumps({k: v[0][:60] for k, v in captions.items()})}")
    log(f"vision tower {vision_ms:.3f} ms (with the projector {encode_ms:.3f} ms); prefill of "
        f"{embeds.shape[1]} tokens {prefill_ms:.3f} ms; decode {step_ms:.3f} ms per token against "
        f"its bound {step_bound:.3f} ms ({decode_bytes(model) / 1e9:.2f} GB of weights at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s); peak {peak:.2f} GiB on {card}")
    model.to("cpu")  # kept for path 6's predictor, off the card while int8 and MPT run
    torch.cuda.empty_cache()

    # int8 weights of the same seed
    torch.cuda.reset_peak_memory_stats()
    model8 = quant.quantize_module_(random_module(lambda: LlavaModel(cfg), 0))
    torch.cuda.empty_cache()
    int8_bytes = quant.module_nbytes(model8)
    with torch.no_grad():
        logits8 = model8.prefill(embeds, embeds.shape[1])[0]
    rel8 = rel_l2(logits8, prompt_logits)
    step8_ms, step8_bound = decode_ms(model8, embeds)
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    log(f"load_8bit: {int8_bytes / 1e9:.2f} GB against {bf16_bytes / 1e9:.2f} GB; prompt logits "
        f"rel L2 against bf16 {rel8:.3e} (reported); decode {step8_ms:.3f} ms per token against "
        f"its bound {step8_bound:.3f} ms ({decode_bytes(model8) / 1e9:.2f} GB, the dequantize "
        f"writes a bf16 copy per product); peak {peak8:.2f} GiB")
    del model8
    torch.cuda.empty_cache()

    mcfg = MPTConfig()
    mpt = random_module(lambda: MPTForCausalLM(mcfg), 1)
    g = torch.Generator(device="cuda").manual_seed(2)
    m_ids = torch.randint(3, mcfg.vocab_size, (1, 616), generator=g, device="cuda")
    with torch.no_grad():
        inc_mpt = incremental_check(mpt, mpt.embed(m_ids), f"MPT ({mcfg.d_model} x "
                                    f"{mcfg.n_layers} x {mcfg.n_heads} heads, ALiBi)")
    del mpt
    torch.cuda.empty_cache()
    return cap, dict(params=n_params, bf16_bytes=bf16_bytes, int8_bytes=int8_bytes,
                prompt_tokens=embeds.shape[1], incremental_rel_l2=inc,
                vision_ms=vision_ms, encode_image_ms=encode_ms, prefill_ms=prefill_ms,
                decode_ms=step_ms, decode_bound_ms=step_bound,
                caption_seconds={k: v[1] for k, v in captions.items()},
                captions={k: v[0] for k, v in captions.items()}, peak_gib=peak,
                int8_logits_rel_l2=rel8, int8_decode_ms=step8_ms,
                int8_decode_bound_ms=step8_bound, int8_peak_gib=peak8,
                mpt_incremental_rel_l2=inc_mpt)


# path 6: the serving stack. One served call of an 8-frame 64x64 clip runs
# one window a step: path 1's per-forward launches (16, 16, 20, 16) once a
# step, and the 3D VAE's bf16 decode (flash in the mid block) in 3 chunks
P6_FRAMES, P6_HW, P6_SEED = 8, 64, 21
P6_LOOP = {"temporal_attention_block": 16 * STEPS, "fused_temporal_resblock": 16 * STEPS,
           "cross_attention_block": 20 * STEPS, "fused_feedforward": 16 * STEPS}
P6_DECODE = {"flash_attention": 3}
P6_REL_TOL = 1e-4  # relative, the eval's metrics on the card against the CPU (fp32, TF32 off)


class InMemoryIO:
    """Stand-ins of ``video_io``'s codec functions (reading, streaming,
    probing the frame rate and writing; the card machine may have no codec
    library): a clip is a file of uint8 frames in numpy's format
    under a video name, in the web demo's work directory, and what the
    predictor and the eval write is kept here, by path, one array per
    write or append. The frame conversions and everything else stay real."""

    def __init__(self):
        self.written = {}
        self.lock = threading.Lock()

    @staticmethod
    def save(path: str, frames_u8: np.ndarray) -> str:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:  # np.save(path) would append ".npy"
            np.save(f, frames_u8)
        return path

    def read_video(self, path):
        return np.load(path), 25.0, os.path.splitext(os.path.basename(path))[0]

    def stream_video(self, path, batch: int = 8):
        frames = np.load(path)
        for i in range(0, len(frames), batch):
            yield frames[i:i + batch]

    def probe_fps(self, path, default: float = 25.0):
        return 25.0

    def write_video(self, path, frames_u8, fps: float = 25.0, quality: int = 8):
        with self.lock:
            self.written[path] = [np.array(frames_u8)]

    def writer(self, path, fps: float = 25.0):
        io = self

        class Writer:
            def append(self, frames_u8):
                with io.lock:
                    io.written.setdefault(path, []).append(np.array(frames_u8))

            def close(self):
                pass
        return Writer()

    def patched(self):
        return patched(video_io, read_video=self.read_video, stream_video=self.stream_video,
                       probe_fps=self.probe_fps, write_video=self.write_video,
                       VideoWriter=self.writer)


class ServedPredictor(Predictor):
    """The port's Predictor with clocks: per request (by its clip's name) the
    job's start and end, its progress ticks with their times (the pipeline
    ticks after a sync), the caption's seconds and the job's launches; the
    worker's own progress callback, when it streams, gets every tick too.
    ``started[name]``, an event the caller makes, is set when that job
    starts."""

    def __init__(self):
        super().__init__()
        self.records, self.started = {}, {}

    def predict(self, video_path, progress_cb=None, **kwargs):
        name = os.path.splitext(os.path.basename(video_path))[0]
        rec = self.records.setdefault(name, dict(ticks=[], caption_s=0.0))
        before = dict(_cuda.LAUNCHES)  # jobs run one at a time: the job's own launches
        rec["start"] = time.time()
        if name in self.started:
            self.started[name].set()

        def tick(stage, i, n):
            rec["ticks"].append((stage, i, n, time.time()))
            if progress_cb is not None:
                progress_cb(stage, i, n)
        caption = self.captioner

        def timed_caption(frame):
            t0 = time.time()
            text = caption(frame)
            rec["caption_s"] += time.time() - t0
            rec["caption"] = text
            return text
        self.captioner = timed_caption
        try:
            return super().predict(video_path, progress_cb=tick, **kwargs)
        finally:
            self.captioner = caption
            rec["end"] = time.time()
            rec["launches"] = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                               if v != before[k]}


class TimedCapture(graphs.CapturedLoop):
    """A captured loop that notes when each capture starts and ends."""
    started = threading.Event()
    spans = []

    def __init__(self, *args):
        start = time.time()
        TimedCapture.started.set()
        super().__init__(*args)
        TimedCapture.spans.append((start, time.time()))


class TimedGraph(torch.cuda.graph):
    """``torch.cuda.graph`` with the seconds of its entry (a sync, the
    allocator's ``empty_cache``, ``capture_begin``), of its body (the loop
    recorded) and of its exit (``capture_end`` and the instantiation)."""
    spans = []

    def __enter__(self):
        t0 = time.perf_counter()
        super().__enter__()
        self._marks = (t0, time.perf_counter())

    def __exit__(self, *args):
        t2 = time.perf_counter()
        out = super().__exit__(*args)
        t0, t1 = self._marks
        TimedGraph.spans.append(dict(enter_s=t1 - t0, body_s=t2 - t1,
                                     exit_s=time.perf_counter() - t2))
        return out


class SeenRing(FrameRing):
    """The native ring, each one made kept in view."""
    made = []

    def __init__(self, *args):
        super().__init__(*args)
        SeenRing.made.append(self)


def http_post(url, payload, stream=False, timeout=600):
    """POST JSON; the decoded reply, or with ``stream`` the NDJSON events.
    An error status comes back as its JSON body."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            if stream:
                return [json.loads(line) for line in resp if line.strip()]
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def stage_seconds(rec):
    """The denoise and decode seconds of a request's pipeline calls (by
    their progress ticks, which come after a sync; summed over segments)
    and the end of its last tick."""
    denoise = decode = 0.0
    mark = rec["start"] + rec["caption_s"]
    for stage, i, n, t in rec["ticks"]:
        if stage == "denoise":
            denoise += t - mark
        elif stage == "decode":
            decode += t - mark
        mark = t
    return denoise, decode, mark


def request_pipeline_s(rec) -> float:
    return sum(stage_seconds(rec)[:2])


def request_stages(rec, posted: float, replied: float, frames: int):
    """A served request's seconds by stage from the predictor's clocks: the
    queue (received at the worker to the job's start), the caption, the
    denoise and the decode, the write and the rest; the pipeline calls'
    seconds; the overhead (the request's seconds less the pipeline calls')
    and what of it is neither queue nor caption: HTTP, the demo and the
    host's frame work."""
    denoise, decode, mark = stage_seconds(rec)
    total = replied - posted
    queue = rec["start"] - rec["received"]
    return dict(request_s=total, queue_s=queue, caption_s=rec["caption_s"],
                denoise_s=denoise, decode_s=decode, write_and_rest_s=rec["end"] - mark,
                pipeline_s=denoise + decode, overhead_s=total - denoise - decode,
                http_and_host_s=total - denoise - decode - queue - rec["caption_s"],
                frames=frames, served_frames_per_s=frames / total)


def run_path6(card: str, checked, llava):
    """The serving stack on the card at released widths: the controller, a
    worker whose Predictor holds ``load_pipeline(random_init=True)`` (3D
    VAE, bf16 decode, the Predictor's defaults) and ``llava`` (path 5's
    13B captioner) on the card, and the web demo, all on 127.0.0.1; video
    IO in memory (:class:`InMemoryIO`). Four requests through the demo:
    R1 an 8-frame 64x64 clip captioned by the captioner; R2 the same
    streamed (NDJSON progress, then the output); R3 a 16-frame clip in two
    8-frame segments through the native ring, posted while R2's loop is
    captured; R4 R1's clip, posted while R3 runs. Gates: every served
    output equals a direct call of the same pipeline on the main thread
    bit for bit (R1's key eager, then captured; R3's segments replayed);
    launches only at checked shapes, as many as the calls predict (R1
    eager, R2 captures, R3-R4 replay); R2's lines are the pipeline's ticks;
    R3's 16 frames in two appends, the ring empty at the end. Then
    ``evaluate_directory`` over two clips with ground truth and LPIPS
    (AlexNet widths, random weights): the card's metrics against the CPU's,
    and a second run that resumes and runs nothing."""
    for var in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY", "all_proxy",
                "ALL_PROXY"):
        os.environ.pop(var, None)  # the servers are local: no proxy
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = "127.0.0.1,localhost"
    work = tempfile.mkdtemp(prefix="uav_path6_")  # the demo's work directory
    io = InMemoryIO()

    t0 = time.time()
    predictor = ServedPredictor()
    predictor.setup(random_weights=True, with_captioner=False, device="cuda")
    llava.model.to("cuda")
    predictor.captioner = lambda frame: printable(llava.caption(frame))
    pipe = predictor.pipeline
    torch.cuda.synchronize()
    log(f"Predictor.setup (released widths, 3D VAE, "
        f"{pipe.m.vae.post_quant_conv.weight.dtype} decode, step_mode {pipe.step_mode}) and "
        f"the 13B captioner back on the card in {time.time() - t0:.1f} s")

    received = {}  # clip name -> time the worker's handler queued it

    def stamp(submit):
        def run(data, *args, **kwargs):
            received[os.path.splitext(os.path.basename(data["video_path"]))[0]] = time.time()
            return submit(data, *args, **kwargs)
        return run

    TimedCapture.started.clear()
    captures, rings, parts = TimedCapture.spans, SeenRing.made, TimedGraph.spans
    for made in (captures, rings, parts):
        made.clear()
    servers = []

    def up(srv):  # serving before the next one registers with it
        servers.append(srv)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    ctrl = up(serve_controller("127.0.0.1", 0))
    ctrl_url = f"http://127.0.0.1:{ctrl.server_address[1]}"
    worker = up(serve_worker("card-0", "127.0.0.1", 0, ctrl_url, predictor)).worker
    worker.submit, worker.submit_stream = stamp(worker.submit), stamp(worker.submit_stream)
    demo = up(serve_web_demo("127.0.0.1", 0, ctrl_url, work_dir=work))
    demo_url = f"http://127.0.0.1:{demo.server_address[1]}"

    clip8 = synthetic_clip(31, P6_FRAMES, P6_HW, P6_HW)
    clip16 = synthetic_clip(32, 2 * P6_FRAMES, P6_HW, P6_HW)
    inputs = {"r1": clip8, "r2": clip8, "r3": clip16, "r4": clip8}
    for name, clip in inputs.items():
        io.save(os.path.join(work, f"{name}.mp4"), clip)
    base = dict(seed=P6_SEED)  # the Predictor's defaults otherwise: -n 150 -g 6 -s 30
    predictor.started = {name: threading.Event() for name in inputs}
    replies, times, threads = {}, {}, {}

    def send(name, payload, stream=False):
        times[name] = [time.time()]
        replies[name] = http_post(demo_url + "/upscale", dict(
            payload, video_path=os.path.join(work, f"{name}.mp4"), stream=stream), stream)
        times[name].append(time.time())

    def start(name, payload, stream=False):
        threads[name] = threading.Thread(target=send, args=(name, payload, stream))
        threads[name].start()

    try:
        with io.patched(), patched(graphs, CapturedLoop=TimedCapture), \
                patched(torch.cuda, graph=TimedGraph), \
                patched(predictor_module, FrameRing=SeenRing):
            if [w for w in http_post(demo_url + "/list_models", {})] != ["card-0"]:
                raise AssertionError("the worker did not register with the controller")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _cuda.reset_launch_counts()
            send("r1", base)
            caption = predictor.records["r1"]["caption"]
            log(f"path 6 R1: caption from the 13B captioner {caption[:60]!r}")
            start("r2", dict(base, caption=caption), stream=True)
            if not TimedCapture.started.wait(300):
                raise AssertionError("R2's call did not capture the denoise loop")
            start("r3", dict(base, caption="a panning field, ", segment_frames=P6_FRAMES))
            predictor.started["r3"].wait(300)
            start("r4", dict(base, caption=caption))
            for thread in threads.values():
                thread.join()
            launches, shapes = dict(_cuda.LAUNCHES), launch_shapes()
            peak = torch.cuda.max_memory_allocated() / 2**30
            reserved = torch.cuda.max_memory_reserved() / 2**30
    finally:
        worker.stop()
        for srv in servers:
            srv.shutdown()
            srv.server_close()

    # gates on the replies, the capture's timing, the ring and the launches
    for name in ("r1", "r3", "r4"):
        if "output" not in replies[name]:
            raise AssertionError(f"path 6 {name} failed: {replies[name]}")
    events = replies["r2"]
    progress = [tuple(e["progress"].values()) for e in events if "progress" in e]
    want_ticks = [t[:3] for t in predictor.records["r2"]["ticks"]]
    if "output" not in events[-1] or progress != want_ticks or want_ticks != (
            [("denoise", STEPS, STEPS)] + [("decode", i, 3) for i in (1, 2, 3)]):
        raise AssertionError(f"path 6 R2's stream {events} against the pipeline's ticks "
                             f"{want_ticks}")
    if len(captures) != 1 or not captures[0][0] <= received["r3"] <= captures[0][1]:
        raise AssertionError(f"R3 must be received while R2's loop is captured: captures "
                             f"{captures}, R3 received at {received.get('r3')}")
    r3_rec = predictor.records["r3"]
    if not r3_rec["start"] <= received["r4"] <= r3_rec["end"]:
        raise AssertionError("R4 must be received while R3 runs")
    if len(rings) != 1 or rings[0].pending() != 0:
        raise AssertionError(f"R3's ring: {len(rings)} made, "
                             f"{rings[0].pending() if rings else '-'} frames left in it")
    out_path = lambda name: os.path.join(work, "results", f"{name}_upscaled.mp4")
    r3_appends = io.written[out_path("r3")]
    if [len(a) for a in r3_appends] != [P6_FRAMES, P6_FRAMES]:
        raise AssertionError(f"R3 wrote {[a.shape for a in r3_appends]}")
    check_launches("path 6 (served R1-R4)", launches, shapes, PATH1_KERNELS, checked)
    # R1 runs the loop eagerly, R2 captures it, R3's two segments and R4 replay
    # it (a replay counts no launch); every call decodes in 3 chunks
    predicted = {"r1": {**P6_LOOP, **P6_DECODE}, "r2": {**P6_LOOP, **P6_DECODE},
                 "r3": {"flash_attention": 2 * P6_DECODE["flash_attention"]}, "r4": P6_DECODE}
    got = {name: predictor.records[name]["launches"] for name in predicted}
    log(f"path 6 launches by request: {json.dumps(got)}")
    if got != predicted:
        raise AssertionError(f"path 6 launches by request {got}, predicted {predicted}")

    # every served output against direct calls of the same pipeline on the
    # same frames, prompt and seed, on the main thread with no request in
    # flight: R1's key again, its first call (eager) and its second
    # (capturing; their seconds against the job thread's), then R3's two
    # segments (replays)
    def direct(frames_u8, prompt, seed):
        video = torch.as_tensor(video_io.to_model_range(frames_u8), device="cuda")[None]
        out = pipe(prompt, video, None, num_inference_steps=STEPS, guidance_scale=6.0,
                   noise_level=150, negative_prompt="blur, worst quality",
                   generator=torch.Generator(device="cuda").manual_seed(seed))
        return video_io.from_model_range(out[0].cpu().numpy())

    a_prompt = "best quality, extremely detailed"
    pipe.graphs.clear()
    with patched(graphs, CapturedLoop=TimedCapture), patched(torch.cuda, graph=TimedGraph):
        main_eager = timed_call(direct, clip8, caption + a_prompt, P6_SEED)
        main_capture = timed_call(direct, clip8, caption + a_prompt, P6_SEED)
        ref3 = [direct(clip16[i * P6_FRAMES:(i + 1) * P6_FRAMES], "a panning field, " + a_prompt,
                       P6_SEED + i) for i in range(2)]
    ref1 = main_eager["out"]
    main_capture_s = captures[-1][1] - captures[-1][0]
    log(f"path 6 R1's key on the main thread: eager call {main_eager['s']:.2f} s, capturing "
        f"call {main_capture['s']:.2f} s (capture {main_capture_s:.2f} s) against R1's pipeline "
        f"{request_pipeline_s(predictor.records['r1']):.2f} s and R2's "
        f"{request_pipeline_s(predictor.records['r2']):.2f} s (capture "
        f"{captures[0][1] - captures[0][0]:.2f} s) on the worker's job thread; the captures by "
        f"part (s), job thread then main thread: {json.dumps(parts)}")
    equal = {name: bool(np.array_equal(io.written[out_path(name)][0], ref1))
             for name in ("r1", "r2", "r4")}
    equal["r3"] = all(np.array_equal(a, r) for a, r in zip(r3_appends, ref3))
    equal["main_thread_capture"] = bool(np.array_equal(main_capture["out"], ref1))
    log(f"path 6 served outputs equal to direct calls on the main thread (bit for bit): "
        f"{json.dumps(equal)}; output {io.written[out_path('r1')][0].shape}")
    if not all(equal.values()):
        raise AssertionError(f"a served output differs from the direct call: {equal}")

    stages = {}
    for name in ("r1", "r2", "r3", "r4"):
        rec = dict(predictor.records[name], received=received[name])
        stages[name] = request_stages(rec, *times[name], len(inputs[name]))
        log(f"path 6 {name.upper()}: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                                                   f"{k} {v}" for k, v in stages[name].items()))
    log(f"path 6 capture of the denoise loop (R2's call) {captures[0][1] - captures[0][0]:.2f} s; "
        f"peak allocated / reserved with the 13B captioner on the card {peak:.2f} / "
        f"{reserved:.2f} GiB on {card}")
    eval_rec = run_eval(pipe, io, work)
    shutil.rmtree(work)
    del predictor, pipe
    torch.cuda.empty_cache()
    return dict(requests=stages, equal=equal, capture_seconds=captures[0][1] - captures[0][0],
                main_thread=dict(eager_s=main_eager["s"], capture_call_s=main_capture["s"],
                                 capture_s=main_capture_s), capture_parts=parts,
                peak_gib=peak, reserved_gib=reserved, caption=caption,
                launches=launches, launches_by_shape=shapes,
                seconds=sum(r["pipeline_s"] for r in stages.values()), eval=eval_rec)


class CountingPipeline:
    """A pipeline that counts its calls and keeps their outputs."""

    def __init__(self, pipe):
        self.pipe, self.outputs = pipe, []

    def __call__(self, *args, **kwargs):
        out = self.pipe(*args, **kwargs)
        self.outputs.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.pipe, name)


def run_eval(pipe, io, work):
    """``evaluate_directory`` over two in-memory 8-frame 64x64 clips with
    ground truth (each clip's frames x4 by nearest) and an LPIPS checkpoint
    in the package's layout (AlexNet widths, seeded random weights), on the
    served pipeline (30 steps: its held graph replays); PSNR, SSIM and
    LPIPS from the card against the same metrics on the CPU; then a second
    run that resumes from the ledger and calls nothing."""
    clips = {"e1": synthetic_clip(41, P6_FRAMES, P6_HW, P6_HW),
             "e2": synthetic_clip(42, P6_FRAMES, P6_HW, P6_HW)}
    for name, clip in clips.items():
        io.save(os.path.join(work, "eval_in", f"{name}.mp4"), clip)
        io.save(os.path.join(work, "eval_gt", f"{name}.mp4"),
                np.repeat(np.repeat(clip, 4, axis=1), 4, axis=2))
    torch.manual_seed(5)
    state = LPIPS("alex").state_dict()
    for k in state:
        if k.startswith("lin"):
            state[k] = torch.rand(state[k].shape) * 0.1
    ckpt = os.path.join(work, "lpips_alex.pth")
    torch.save(state, ckpt)
    kw = dict(gt_dir=os.path.join(work, "eval_gt"), lpips_ckpt=ckpt, seed=3)
    counted = CountingPipeline(pipe)
    _cuda.reset_launch_counts()
    t0 = time.time()
    with io.patched():
        agg = evaluate_directory(counted, os.path.join(work, "eval_in"),
                                 os.path.join(work, "eval_out"), **kw)
        secs = time.time() - t0
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        again = CountingPipeline(pipe)
        agg2 = evaluate_directory(again, os.path.join(work, "eval_in"),
                                  os.path.join(work, "eval_out"), **kw)
    with open(os.path.join(work, "eval_out", "eval_report.jsonl")) as f:
        report = [json.loads(line) for line in f if line.strip()]
    if again.outputs or agg2 != agg or len(report) != 2 or launches != {"flash_attention": 6}:
        raise AssertionError(f"eval: resumed run called the pipeline {len(again.outputs)} "
                             f"times, aggregates {agg} then {agg2}, {len(report)} report lines, "
                             f"launches {launches} (predicted 3 decode chunks a clip)")
    lp_cpu = load_lpips(ckpt, "alex")
    worst = 0.0
    for entry, out in zip(report, counted.outputs):
        gt = torch.as_tensor(video_io.to_model_range(
            np.repeat(np.repeat(clips[entry["clip"]], 4, axis=1), 4, axis=2)))
        pred = out[0].cpu()
        with torch.no_grad():
            cpu = {"psnr": float(psnr(pred, gt).mean()), "ssim": float(ssim(pred, gt).mean()),
                   "lpips": float(lp_cpu(pred, gt).mean())}
        rel = {k: abs(entry[k] - v) / abs(v) for k, v in cpu.items()}
        worst = max(worst, *rel.values())
        log(f"eval {entry['clip']}: card {json.dumps({k: entry[k] for k in cpu})}, CPU "
            f"{json.dumps(cpu)}, relative differences {json.dumps(rel)}")
    log(f"eval: {len(report)} clips in {secs:.2f} s (report: {json.dumps(agg)}); resumed run "
        f"called the pipeline {len(again.outputs)} times; card vs CPU metrics within "
        f"{worst:.3e} relative (tol {P6_REL_TOL})")
    if not worst <= P6_REL_TOL:
        raise AssertionError(f"eval metrics on the card differ from the CPU's: {worst:.3e}")
    return dict(aggregates=agg, report=report, seconds=secs, worst_rel=worst,
                launches=launches)


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

    wanted = (set(sys.argv[sys.argv.index("--paths") + 1].split(","))
              if "--paths" in sys.argv else set(ALL_PATHS))
    paths = {}
    if "1" in wanted:
        phase("path 1: model (random weights on the card)")
        t0 = time.time()
        pipe = random_pipeline(device="cuda", seed=0)
        torch.cuda.synchronize()
        log(f"built the pipeline in {time.time() - t0:.1f} s")
        phase("path 1: unet")
        unet1 = check_unet(pipe, 8, LR, LR)
        phase("path 1: e2e, scan against host, PAB")
        paths["path1"] = dict(run_path1(pipe, card, checked), unet=unet1)
        del pipe
        torch.cuda.empty_cache()

    if "2" in wanted:
        phase("path 2: model (random weights on the card, video VAE)")
        t0 = time.time()
        pipe = random_pipeline(device="cuda", seed=0, vae_config=VIDEO_VAE)
        torch.cuda.synchronize()
        log(f"built the pipeline in {time.time() - t0:.1f} s")
        phase("path 2: unet at T = 5")
        unet2 = check_unet(pipe, FRAMES2, H2, W2)
        phase("path 2: e2e, scan against host")
        paths["path2"] = dict(run_path2(pipe, card, checked), unet=unet2)
        del pipe
        torch.cuda.empty_cache()

    if "3" in wanted:
        phase("path 3: the headline command with -p 24,26,28 (RAFT, propagation, encoder)")
        paths["path3"] = run_path3(card, checked)
        torch.cuda.empty_cache()

    if "4" in wanted:
        phase("path 4: the CLI's per-clip step, two 128x192 tiles batched, -p 24,26,28")
        paths["path4"] = run_path4(card, checked)
        torch.cuda.empty_cache()

    path5 = llava = None
    if "5" in wanted:
        phase("path 5: the captioner (LLaVA-1.5-13B widths, random weights), int8, MPT")
        llava, path5 = run_path5(card)

    if "6" in wanted:
        phase("path 6: serving (web demo, controller, worker, Predictor, the 13B captioner), "
              "then the eval harness")
        if llava is None:
            llava = LlavaCaptioner(random_module(lambda: LlavaModel(LlavaConfig()), 0),
                                   tokenizer=ByteTokenizer(), max_new_tokens=64)
        paths["path6"] = run_path6(card, checked, llava)
        del llava
        torch.cuda.empty_cache()

    by_key = {(r["name"], json.dumps(r["shape"])): r for r in recs}
    for name, p in paths.items():  # fault C1 in one run: the kernels against the plain route
        # one call's launches (paths 1-2: the host call's; each path's count is one loop's)
        one_run = p.get("loop_launches_by_shape", p["launches_by_shape"])
        per_kernel = p["kernel_seconds"] = kernel_seconds(one_run, by_key)
        kern, plain = (sum(v[r] for v in per_kernel.values()) for r in ("kernels", "plain"))
        each = ", ".join(f"{k} {v['kernels']:.3f}/{v['plain']:.3f}" for k, v in per_kernel.items())
        route = (f" (host {p['host_seconds']:.2f} s) against the plain route (host) "
                 f"{p['plain_seconds']:.2f} s" if "plain_seconds" in p else "")
        log(f"{name}: kernels as isolated calls {kern:.3f} s against their plain versions "
            f"{plain:.3f} s ({each}); e2e {p['seconds']:.2f} s{route}")
    with open("chiprun_out/chip_smoke_kernels.json", "w") as f:
        json.dump({"card": card, "steps": STEPS, "build_seconds": build_secs, "paths": paths,
                   "path5": path5, "kernels": recs}, f, indent=1)
    if wanted != set(ALL_PATHS):
        phase(f"done: paths {sorted(wanted)} only (no result line; records in "
              f"chiprun_out/chip_smoke_kernels.json), whole script {time.time() - T0:.1f} s")
        return 0
    main_shape = {}
    for r in recs:  # the largest slice shape of each kernel stands for it
        if r["name"] not in main_shape or r["bound_ms"] > main_shape[r["name"]]["bound_ms"]:
            main_shape[r["name"]] = r
    kernels = []
    for name, r in main_shape.items():
        src, replaces = SOURCES[name]
        by_path = {p: v["launches"][name] + v.get("extra_launches", {}).get(name, 0)
                   for p, v in paths.items()}
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
