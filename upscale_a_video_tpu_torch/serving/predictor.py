"""The serving predictor (the Cog/Replicate deployment surface).

Port of ``upscale_a_video_tpu/serving/predictor.py`` on the port's pipeline,
with the JAX defaults: noise level 150, guidance 6.0, 30 steps, the
``a_prompt``/``n_prompt`` pair, tiles of 256, a random seed when none is
given, a bf16 decode. Against the CLI, a request may bring its own caption
(it overrides the captioner) and its seed. ``setup`` loads the models once
on ``cuda``, unless the caller names the CPU; ``predict`` runs the CLI's
path: the area rule for inputs of 1280 x 1280 and more, RAFT's flows for
``propagation_steps``, the tiles one at a time, the colour fix.

The seed becomes a ``torch.Generator`` on the pipeline's device, made anew
for every pipeline call (every tile of a clip starts from it, as the JAX
predictor hands one key to every tile); in streaming mode segment ``i``
takes ``seed + i``. As in JAX, the predictor has no rule for clips over 8
frames: that is the CLI's.
"""

from __future__ import annotations

import itertools
import os
import queue
import secrets
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..captioner import build_captioner
from ..models.raft import compute_bidirectional_flows, load_raft
from ..ops.resize import resize_2d
from ..pipeline.color import apply_color_fix
from ..pipeline.loader import load_pipeline
from ..pipeline.tiled_run import run_tiled
from ..pipeline.tiling import needs_tiling
from ..utils import video_io
from ..utils.stream import FrameRing

STREAM_BATCH = 8  # frames a ring slot holds (the decoder's batch)
STREAM_SLOTS = 4  # ring slots: the host holds at most these batches and one in flight


class Predictor:
    def __init__(self):
        self.pipeline = None
        self.raft = None
        self.captioner = None
        self.model_dir = None

    def setup(self, model_dir: str = "./pretrained_models/upscale_a_video",
              use_video_vae: bool = False, random_weights: bool = False,
              with_captioner: bool = True, device=None) -> None:
        """Load the pipeline (bf16 decode) and, with ``with_captioner``, the
        first configured captioner (``captioner.build_captioner``)."""
        self.model_dir = model_dir
        self.pipeline = load_pipeline(None if random_weights else model_dir,
                                      use_video_vae=use_video_vae, decode_dtype=torch.bfloat16,
                                      random_init=random_weights, device=device)
        if with_captioner:
            self.captioner = build_captioner(device=self.pipeline.device)

    def predict(self, video_path: str, output_path: str = "./results", noise_level: int = 150,
                guidance_scale: float = 6.0, inference_steps: int = 30,
                propagation_steps: Sequence[int] = (), caption: Optional[str] = None,
                a_prompt: str = "best quality, extremely detailed",
                n_prompt: str = "blur, worst quality", color_fix: str = "None",
                tile_size: int = 256, seed: Optional[int] = None,
                segment_frames: Optional[int] = None, progress_cb=None) -> str:
        """Upscale one video; returns the path of the output mp4.

        ``segment_frames``: streaming mode. Frames are decoded in batches
        through the native ring, segments of ``segment_frames`` go through
        the pipeline, and each segment's frames are appended to the mp4 as
        it is done, so the host never holds the whole video (the segment is
        the unit of temporal context).
        ``progress_cb(stage, i, n)``: the pipeline's ``"denoise"`` and
        ``"decode"`` ticks, and the predictor's own ``"tile"`` and
        ``"segment"`` ticks (a segment's ``n`` is -1: a stream's length is
        unknown)."""
        if self.pipeline is None:
            raise RuntimeError("call setup() first")
        if seed is None:
            seed = secrets.randbelow(2**31)
        common = dict(num_inference_steps=inference_steps, guidance_scale=guidance_scale,
                      noise_level=noise_level, negative_prompt=n_prompt,
                      propagation_steps=list(propagation_steps))
        if segment_frames is not None:
            return self._predict_streaming(video_path, output_path, common, caption, a_prompt,
                                           color_fix, tile_size, seed, segment_frames,
                                           progress_cb)

        frames_u8, fps, name = video_io.read_video(video_path)
        if caption is None and self.captioner is not None:
            caption = self.captioner(frames_u8[0])
        prompt = (caption or "") + a_prompt
        video = torch.as_tensor(video_io.to_model_range(frames_u8), device=self.pipeline.device)
        h, w = video.shape[1:3]
        if h >= 1280 and w >= 1280:
            video = resize_2d(video, (h // 4, w // 4), "area")

        t0 = time.time()
        output = self._run_clip(prompt, video[None], common, color_fix, tile_size, seed,
                                progress_cb)
        out_file = os.path.join(output_path, f"{name}_upscaled.mp4")
        video_io.write_video(out_file, video_io.from_model_range(output[0].cpu().numpy()), fps)
        print(f"predict: {time.time() - t0:.1f}s → {out_file}", flush=True)
        return out_file

    def _flows(self, video: torch.Tensor):
        """RAFT's flows of ``video``: the bundle's raft-things.pth (loaded
        with the pipeline, else at the first call), random weights when the
        file is absent."""
        if self.raft is None:
            self.raft = self.pipeline.m.raft
        if self.raft is None:
            path = os.path.join(self.model_dir or "", "propagator/raft-things.pth")
            self.raft = load_raft(path if os.path.exists(path) else None,
                                  device=self.pipeline.device)
        return compute_bidirectional_flows(self.raft, video)

    def _run_clip(self, prompt: str, video: torch.Tensor, common: dict, color_fix: str,
                  tile_size: int, seed: int, progress_cb=None) -> torch.Tensor:
        """Flows, the tiled (one tile a call) or direct pipeline call and the
        colour fix of one clip: video (1, T, H, W, 3) → (1, T, 4H, 4W, 3)."""
        flows_bi = self._flows(video) if common["propagation_steps"] else None
        h, w = video.shape[2:4]
        if needs_tiling(h, w):
            on_tile = None if progress_cb is None else (
                lambda done, total: progress_cb("tile", done, total))
            output = run_tiled(self.pipeline, prompt, video, flows_bi, tile_size=tile_size,
                               overlap=64, tile_batch=1, seed=seed, on_tile=on_tile,
                               progress_cb=progress_cb, **common)
        else:
            generator = torch.Generator(device=video.device).manual_seed(seed)
            output = self.pipeline(prompt, video, flows_bi, generator=generator,
                                   progress_cb=progress_cb, **common)
        return apply_color_fix(color_fix, output[0], video[0])[None]

    def _predict_streaming(self, video_path, output_path, common, caption, a_prompt, color_fix,
                           tile_size, seed, segment_frames, progress_cb) -> str:
        """Bounded ingest → a pipeline call per segment → incremental write.
        A decode thread pushes batches of :data:`STREAM_BATCH` frames
        (zero-padded; their lengths ride a queue beside the ring) into a
        ring of :data:`STREAM_SLOTS` slots; segments go out as soon as they
        are full, the last one with what is left."""
        frame_iter = video_io.stream_video(video_path, batch=STREAM_BATCH)
        first = next(frame_iter)
        if caption is None and self.captioner is not None:
            caption = self.captioner(first[0])
        prompt = (caption or "") + a_prompt
        slot_shape = (STREAM_BATCH,) + first.shape[1:]
        ring = FrameRing(STREAM_SLOTS, slot_shape, np.uint8)
        lengths: "queue.Queue[Optional[int]]" = queue.Queue()

        def produce():
            try:
                for batch in itertools.chain([first], frame_iter):
                    pad = np.zeros(slot_shape, np.uint8)
                    pad[:len(batch)] = batch
                    ring.push(pad)
                    lengths.put(len(batch))
            finally:
                lengths.put(None)
                ring.close()

        threading.Thread(target=produce, daemon=True).start()
        name = os.path.splitext(os.path.basename(video_path))[0]
        out_file = os.path.join(output_path, f"{name}_upscaled.mp4")
        writer = video_io.VideoWriter(out_file, video_io.probe_fps(video_path))
        seg_idx = 0
        t0 = time.time()

        def flush(frames_u8: np.ndarray) -> None:
            nonlocal seg_idx
            video = torch.as_tensor(video_io.to_model_range(frames_u8),
                                    device=self.pipeline.device)[None]
            out = self._run_clip(prompt, video, common, color_fix, tile_size, seed + seg_idx,
                                 progress_cb)
            writer.append(video_io.from_model_range(out[0].cpu().numpy()))
            seg_idx += 1
            if progress_cb is not None:
                progress_cb("segment", seg_idx, -1)

        pending = np.zeros((0,) + first.shape[1:], np.uint8)
        try:
            while (n := lengths.get()) is not None:
                pending = np.concatenate([pending, ring.pop()[:n]])
                while len(pending) >= segment_frames:
                    flush(pending[:segment_frames])
                    pending = pending[segment_frames:]
            if len(pending):
                flush(pending)
        finally:
            writer.close()
        print(f"predict[stream]: {time.time() - t0:.1f}s → {out_file}", flush=True)
        return out_file
