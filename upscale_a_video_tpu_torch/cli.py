"""Command line of the port, with the argv of the JAX CLI
(``upscale_a_video_tpu/cli.py:29-73``, itself the reference's) plus
``--device``:

    python -m upscale_a_video_tpu_torch.cli -i input.mp4 -o results \\
        -n 120 -g 6 -s 30 -p 24,26,28 --use_video_vae --color_fix Wavelet --no_llava

It runs on ``cuda`` unless ``--device cpu`` is given (the plain PyTorch
versions of the kernels then). Flags with a port meaning:
- ``--decode_fp32``: the VAE decodes in fp32; without it in bf16, as the JAX
  CLI does.
- ``--decode_attn fp32``: fp32 q/k/v in the VAE's mid-block attention
  (``SpatialAttentionBlock.fp32_operands``), on the card through the fp32
  flash kernel.
- ``--seed``: seeds a fresh torch generator for every pipeline call (every
  tile call starts from the same seed, as the JAX CLI's one key).
- ``-p``: RAFT from ``<model_dir>/propagator/raft-things.pth``, random
  weights when the file is absent.
- without ``--no_llava`` the captioner of ``captioner.build_captioner``
  captions frame 0 and the caption is prepended to ``--a_prompt``; with no
  backend configured (``UAV_CAPTION_TORCH_MODEL``, ``UAV_CAPTION_ENDPOINT``)
  the caption is empty, as in the JAX CLI. ``--load_8bit_llava`` stores the
  local model's large weights in int8.
- clips over 8 frames run the denoise step by step from the host, one
  window per UNet call (``step_mode="host"``, ``window_group`` 1, as the
  JAX CLI); shorter ones as one CUDA graph (``"scan"``).
The JAX CLI's compile-cache settings have no counterpart.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from .captioner import build_captioner
from .config import resolve_device
from .models.raft import compute_bidirectional_flows, load_raft
from .nn.attention import SpatialAttentionBlock
from .ops.resize import resize_2d
from .pipeline.color import apply_color_fix
from .pipeline.loader import load_pipeline
from .pipeline.tiled_run import run_tiled
from .pipeline.tiling import needs_tiling, plan_tiles
from .utils import video_io


def str_to_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",")] if s else []


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("upscale-a-video-torch")
    p.add_argument("-i", "--input_path", type=str, default="./inputs")
    p.add_argument("-o", "--output_path", type=str, default="./results")
    p.add_argument("-n", "--noise_level", type=int, default=120)
    p.add_argument("-g", "--guidance_scale", type=float, default=6)
    p.add_argument("-s", "--inference_steps", type=int, default=30)
    p.add_argument("-p", "--propagation_steps", type=str_to_list, default=[])
    p.add_argument("--a_prompt", type=str, default="best quality, extremely detailed")
    p.add_argument("--n_prompt", type=str, default="blur, worst quality")
    p.add_argument("--use_video_vae", action="store_true", default=False)
    p.add_argument("--color_fix", type=str, default="None",
                   choices=["None", "AdaIn", "Wavelet"])
    p.add_argument("--no_llava", action="store_true", default=False)
    p.add_argument("--load_8bit_llava", action="store_true", default=False)
    p.add_argument("--perform_tile", action="store_true", default=False)
    p.add_argument("--tile_size", type=int, default=256)
    p.add_argument("--tile_batch", type=int, default=1,
                   help="tiles of one shape batched per pipeline call")
    p.add_argument("--save_image", action="store_true", default=False)
    p.add_argument("--save_suffix", type=str, default="")
    p.add_argument("--model_dir", type=str,
                   default="./pretrained_models/upscale_a_video")
    p.add_argument("--random_weights", action="store_true", default=False,
                   help="random-init models (the bundle's configs when --model_dir has them)")
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--max_frames", type=int, default=0,
                   help="process only the first N frames of each clip (0 = all)")
    p.add_argument("--max_size", type=int, default=0,
                   help="area-downsample inputs whose long side exceeds this "
                        "(0 = only the reference's >=1280^2 rule applies)")
    p.add_argument("--decode_fp32", action="store_true", default=False,
                   help="decode the VAE in fp32 (reference parity); default bf16")
    p.add_argument("--decode_attn", type=str, default="bf16", choices=("fp32", "bf16"),
                   help="operand type of the fp32 decode's mid-block attention")
    p.add_argument("--w_lr", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p


def load_models(args, device: torch.device):
    """The pipeline and, with ``-p``, RAFT, as the JAX CLI builds them
    (``cli.py:119-142``); with ``--random_weights`` a ``--model_dir`` that
    exists still gives the configs."""
    model_dir = args.model_dir if os.path.isdir(args.model_dir) else None
    pipeline = load_pipeline(
        model_dir, use_video_vae=args.use_video_vae,
        decode_dtype=torch.float32 if args.decode_fp32 else torch.bfloat16,
        random_init=args.random_weights, device=device)
    if args.decode_attn == "fp32":
        for m in pipeline.m.vae.modules():
            if isinstance(m, SpatialAttentionBlock):
                m.fp32_operands = True
    raft = None
    if args.propagation_steps:
        raft = pipeline.m.raft  # the bundle's raft-things.pth, loaded with the weights
        if raft is None:
            raft_path = os.path.join(args.model_dir, "propagator/raft-things.pth")
            raft = load_raft(raft_path if os.path.exists(raft_path) else None, device=device)
    return pipeline, raft


def input_list(path: str) -> List[str]:
    """A video file, a folder of frames, or a folder of videos (ref :139-150)."""
    if path.endswith(video_io.VIDEO_EXTENSIONS):
        return [path]
    if os.path.isdir(path):
        if any(f.endswith(video_io.IMAGE_EXTENSIONS) for f in os.listdir(path)):
            return [path]
        videos = video_io.get_video_paths(path)
        if videos:
            return videos
    raise ValueError(f"invalid input: {path}")


def upscale_clip(pipeline, raft, frames: np.ndarray, args, caption: str = "",
                 **call_kwargs) -> torch.Tensor:
    """frames (T, H, W, 3) float32 in [-1, 1] → (T, 4H', 4W', 3) fp32 on the
    pipeline's device, H', W' after the area rules (``cli.py:178-247``):
    flows, the tiled or direct pipeline call with the prompt ``caption +
    a_prompt``, the colour fix."""
    video = torch.as_tensor(frames, device=pipeline.device)
    h, w = video.shape[1:3]
    if h >= 1280 and w >= 1280:  # ref :184-185
        video = resize_2d(video, (h // 4, w // 4), "area")
        h, w = video.shape[1:3]
    if args.max_size and max(h, w) > args.max_size:
        s = args.max_size / max(h, w)
        nh, nw = max(8, int(h * s)) // 8 * 8, max(8, int(w * s)) // 8 * 8
        video = resize_2d(video, (nh, nw), "area")
        h, w = video.shape[1:3]
    video = video[None]
    if video.shape[1] > 8:  # step by step, one window per UNet call (cli.py:209-211)
        pipeline.step_mode = "host"
        pipeline.window_group = 1

    flows_bi = None
    if raft is not None:
        if hasattr(pipeline, "compute_flows"):  # a sharded pipeline: RAFT over its ranks
            flows_bi = pipeline.compute_flows(raft, video)
        else:
            flows_bi = compute_bidirectional_flows(raft, video)

    common = dict(num_inference_steps=args.inference_steps,
                  guidance_scale=args.guidance_scale, noise_level=args.noise_level,
                  negative_prompt=args.n_prompt, propagation_steps=args.propagation_steps,
                  w_lr=args.w_lr, **call_kwargs)
    prompt = caption + args.a_prompt
    if args.perform_tile or needs_tiling(h, w):
        n_tiles = len(plan_tiles(h, w, args.tile_size, 64))
        print(f"        Processing the video w/ {n_tiles} tile patches...", flush=True)
        output = run_tiled(pipeline, prompt, video, flows_bi, tile_size=args.tile_size,
                           overlap=64, tile_batch=args.tile_batch, seed=args.seed, **common)
    else:
        print("        Processing the video w/o tile...", flush=True)
        generator = torch.Generator(device=pipeline.device).manual_seed(args.seed)
        output = pipeline(prompt, video, flows_bi, generator=generator, **common)
    return apply_color_fix(args.color_fix, output[0], video[0])


def process_clip(pipeline, raft, frames_u8: np.ndarray, args, captioner=None,
                 **call_kwargs) -> np.ndarray:
    """One clip through the CLI's steps: (T, H, W, 3) uint8 → (T, 4H', 4W',
    3) uint8 (the caption of frame 0 when there is a captioner, then
    :func:`upscale_clip` between the native frame conversions)."""
    caption = ""
    if captioner is not None:  # JAX cli.py:180-184
        caption = captioner(frames_u8[0])
        print(f"        Caption: {caption}", flush=True)
    output = upscale_clip(pipeline, raft, video_io.to_model_range(frames_u8), args, caption,
                          **call_kwargs)
    return video_io.from_model_range(output.cpu().numpy())


def save_name(name: str, args) -> str:
    """The reference's output name (ref :322-326, JAX ``cli.py:253-258``)."""
    prop = ("_p" + "_".join(map(str, args.propagation_steps))
            if args.propagation_steps else "")
    suffix = "_" + args.save_suffix if args.save_suffix else ""
    g = args.guidance_scale
    g_str = str(int(g)) if float(g).is_integer() else str(g)
    return f"{name}_n{args.noise_level}_g{g_str}_s{args.inference_steps}{prop}{suffix}"


def write_results(args, name: str, frames_u8: np.ndarray, fps: float) -> None:
    """``video/<save name>.mp4`` and, with ``--save_image``, PNG frames under
    ``frame/<save name>/``."""
    stem = save_name(name, args)
    if args.save_image:
        video_io.write_frames(os.path.join(args.output_path, "frame", stem), frames_u8)
    video_io.write_video(os.path.join(args.output_path, "video", f"{stem}.mp4"), frames_u8,
                         fps)


def run(args) -> None:
    device = resolve_device(args.device)
    print("Loading Upscale-A-Video (PyTorch port)", flush=True)
    pipeline, raft = load_models(args, device)
    captioner = None if args.no_llava else build_captioner(args.load_8bit_llava, device)
    videos = input_list(args.input_path)
    # decode lookahead: clip k+1 is read on a host thread while the card runs clip k
    with ThreadPoolExecutor(max_workers=1) as reader:
        pending = reader.submit(video_io.read_video, videos[0])
        for vi in range(len(videos)):
            frames_u8, fps, name = pending.result()
            if vi + 1 < len(videos):
                pending = reader.submit(video_io.read_video, videos[vi + 1])
            if args.max_frames:
                frames_u8 = frames_u8[:args.max_frames]
            tag = f"[{vi + 1}/{len(videos)}]"
            print(f"{tag} Processing video: {name}", flush=True)
            start = time.time()
            out_u8 = process_clip(pipeline, raft, frames_u8, args, captioner)
            run_time = time.time() - start
            write_results(args, name, out_u8, fps)
            print(f"{tag} Saved. time (sec): {run_time:.2f}\n", flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
