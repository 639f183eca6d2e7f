"""Multi-GPU drop-in pipeline: ``VideoUpscalePipeline``'s call backed by the
window-split denoise and the chunk-split decode (port of
``upscale_a_video_tpu/parallel/eval_pipeline.py``).

``pipeline/eval.py::evaluate_directory`` and the CLI take any pipeline;
this one runs one clip over the ranks of a process group: every rank calls
it with the same arguments and gets the same frames. Text encoding, LR
noising, latent draws and the seeds are the single-device pipeline's, so a
seed gives the same noise. The denoise runs from the host step by step (its
collectives are not captured into a CUDA graph), whatever ``step_mode``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..pipeline.pipeline import PABConfig, PipelineModules, VideoUpscalePipeline
from .decode import build_sharded_decode
from .flow import build_sharded_flows
from .mesh import axis_group
from .window_parallel import build_window_sharded_denoise


class ShardedVideoUpscalePipeline(VideoUpscalePipeline):
    """A VideoUpscalePipeline whose denoise splits the sliding-window items
    of each step over ``mesh``'s ``axis`` (all ranks when ``mesh`` is None)
    and whose chunked VAE decode deals the 3-frame chunks out over the same
    ranks. Needs an initialised process group."""

    def __init__(self, modules: PipelineModules, mesh=None, axis: str = "win", device=None,
                 pab: Optional[PABConfig] = None):
        axis_group(mesh, axis)
        super().__init__(modules, device=device, pab=pab, step_mode="host")
        self.mesh = mesh
        self.axis = axis
        self._denoise_cache = {}
        self._decode_cache = {}
        self._flow_fn = self._flow_runner = None

    @torch.no_grad()
    def denoise(self, lat, image_noised, prompt_embeds, level, flows_f, flows_b, *,
                num_inference_steps: int, guidance_scale: float, propagation_steps=(),
                tick=None) -> torch.Tensor:
        """The loop of :meth:`VideoUpscalePipeline.denoise` over the ranks
        (``window_parallel.build_window_sharded_denoise``, built once per
        clip shape and call options)."""
        b, t = lat.shape[:2]
        do_cfg = guidance_scale > 1.0
        key = (tuple(lat.shape), num_inference_steps, float(guidance_scale),
               frozenset(propagation_steps), self.pab)
        if key not in self._denoise_cache:
            self._denoise_cache[key] = build_window_sharded_denoise(
                self.m.unet, self.m.scheduler, self.mesh, num_inference_steps,
                guidance_scale if do_cfg else 0.0, num_frames=t, batch=b, axis=self.axis,
                window=self.WINDOW, stride=self.STRIDE, compute_dtype=self.dtype,
                propagation_steps=propagation_steps, pab=self.pab)
        rows = 2 if do_cfg else 1  # the CFG rows: [uncond, cond], as prompt_embeds
        return self._denoise_cache[key](
            lat, torch.cat([image_noised] * rows), prompt_embeds, torch.cat([level] * rows),
            flows_f, flows_b, tick=tick)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, image_dec: Optional[torch.Tensor] = None,
                       w_lr: float = 1.0, progress_cb=None) -> torch.Tensor:
        key = (latents.shape[1], float(w_lr))
        if key not in self._decode_cache:
            self._decode_cache[key] = build_sharded_decode(
                self.m.vae, self.mesh, num_frames=latents.shape[1], chunk=self.DECODE_CHUNK,
                axis=self.axis, w_lr=w_lr)
        with self._stage(self.m.vae):
            out = self._decode_cache[key](latents, image_dec)
        self._tick(progress_cb, "decode", 1, 1)  # one split call decodes every chunk
        return out

    def compute_flows(self, runner, frames: torch.Tensor):
        """Bidirectional flows over this pipeline's ranks
        (``flow.build_sharded_flows``): in place of
        ``models.raft.compute_bidirectional_flows`` in the eval and the CLI."""
        if self._flow_runner is not runner:
            self._flow_fn = build_sharded_flows(runner, self.mesh, self.axis)
            self._flow_runner = runner
        return self._flow_fn(frames)
