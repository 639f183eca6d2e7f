"""Batch evaluation harness (YouHQ40-style): the upscaler over a directory
of clips, with per-clip resume, PSNR/SSIM (and LPIPS) against ground truth,
and a JSON-lines report.

Port of ``upscale_a_video_tpu/pipeline/eval.py``: the same arguments, report
(``<output_dir>/eval_report.jsonl`` unless named) and ledger
(``<output_dir>/eval_ledger.jsonl``, ``utils/checkpoint.ClipLedger``) files,
the same aggregates, and the next clip read on a host thread while the card
runs the current one. A ``torch.Generator`` seeded with ``seed`` takes the
place of ``PRNGKey(seed)`` for every clip, so a resumed run's clip gives the
output the first run would have. Clips are independent: shards of a
directory go to separate processes, each with its own ledger.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils import video_io
from ..utils.checkpoint import ClipLedger
from ..utils.lpips import load_lpips
from ..utils.metrics import psnr, ssim


def evaluate_directory(pipeline, input_dir: str, output_dir: str, gt_dir: Optional[str] = None,
                       num_inference_steps: int = 30, guidance_scale: float = 6.0,
                       noise_level: int = 120, prompt: str = "best quality, extremely detailed",
                       negative_prompt: str = "blur, worst quality",
                       max_frames: Optional[int] = None, seed: int = 10,
                       report_path: Optional[str] = None, lpips_ckpt: Optional[str] = None,
                       lpips_net: str = "alex") -> dict:
    """Upscale every clip of ``input_dir`` not in the ledger yet, write
    ``<output_dir>/video/<clip>.mp4`` and a report line per clip (frames,
    seconds, frames/s; PSNR and SSIM against ``gt_dir/<clip>.*`` when it
    exists, and LPIPS with ``lpips_ckpt``, an ``lpips`` package checkpoint).
    Returns the aggregates over every line of the report, earlier runs'
    included: the clip count and the means of fps, psnr, ssim and lpips."""
    dev = pipeline.device
    lpips_model = None
    if lpips_ckpt is not None and gt_dir is not None:
        lpips_model = load_lpips(lpips_ckpt, net=lpips_net, device=dev)

    os.makedirs(output_dir, exist_ok=True)
    report_path = report_path or os.path.join(output_dir, "eval_report.jsonl")
    ledger = ClipLedger(os.path.join(output_dir, "eval_ledger.jsonl"))
    clips = video_io.get_video_paths(input_dir)
    if not clips:
        raise ValueError(f"no clips in {input_dir}")
    todo = [c for c in clips if not ledger.is_done(Path(c).stem)]

    with ThreadPoolExecutor(max_workers=1) as reader:
        pending = reader.submit(video_io.read_video, todo[0]) if todo else None
        for ci, clip_path in enumerate(todo):
            name = Path(clip_path).stem
            frames_u8, fps, _ = pending.result()
            if ci + 1 < len(todo):
                pending = reader.submit(video_io.read_video, todo[ci + 1])
            if max_frames:
                frames_u8 = frames_u8[:max_frames]
            video = torch.as_tensor(video_io.to_model_range(frames_u8), device=dev)[None]

            t0 = time.time()
            out = pipeline(prompt, video, num_inference_steps=num_inference_steps,
                           guidance_scale=guidance_scale, noise_level=noise_level,
                           negative_prompt=negative_prompt,
                           generator=torch.Generator(device=dev).manual_seed(seed))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.time() - t0
            entry = {"clip": name, "frames": int(frames_u8.shape[0]), "sec": round(dt, 3),
                     "fps": round(frames_u8.shape[0] / dt, 3)}

            gt_path = None if gt_dir is None else next(Path(gt_dir).glob(f"{name}.*"), None)
            if gt_path is not None:
                gt_u8, _, _ = video_io.read_video(str(gt_path))
                gt = torch.as_tensor(video_io.to_model_range(gt_u8[:out.shape[1]]), device=dev)
                pred = out[0][:gt.shape[0]]
                entry["psnr"] = float(psnr(pred, gt).mean())
                entry["ssim"] = float(ssim(pred, gt).mean())
                if lpips_model is not None:
                    with torch.no_grad():
                        entry["lpips"] = float(lpips_model(pred, gt).mean())

            video_io.write_video(os.path.join(output_dir, "video", f"{name}.mp4"),
                                 video_io.from_model_range(out[0].cpu().numpy()), fps)
            with open(report_path, "a") as f:
                f.write(json.dumps(entry) + "\n")
            ledger.mark_done(name, sec=entry["sec"])

    entries = []
    if os.path.exists(report_path):
        with open(report_path) as f:
            entries = [json.loads(line) for line in f if line.strip()]
    agg = {"clips": len(entries)}
    for k in ("fps", "psnr", "ssim", "lpips"):
        vals = [e[k] for e in entries if k in e]
        if vals:
            agg[k] = round(float(np.mean(vals)), 4)
    return agg
