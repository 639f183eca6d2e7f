"""Time-split denoise: the whole denoising loop with the frame axis spread
over ranks (port of ``upscale_a_video_tpu/parallel/sharded_pipeline.py``;
BASELINE config #5, long-video batched eval with temporal-chunk sharding).

Each rank holds T / N frames of the latents and of the noised LR frames; the
UNet windows of each step are computed chunk by chunk with the halo and
spill exchange that reproduces the serial window plan
(``temporal.windowed_apply_local``); the DDIM split step is element-wise
per frame and exchanges nothing. Propagation (``-p``) is frame-sequential
and stays equal to the serial plan: its recurrence is pipelined over the
ranks with single-frame boundary exchanges (``propagation.py``), 2·(N-1)
boundary frames a propagation step instead of a gather of the clip.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .mesh import all_gather, axis_group
from .propagation import distributed_propagate_latents
from .temporal import local_window_count, windowed_apply_local


def build_sharded_denoise(unet, scheduler, mesh, num_inference_steps: int,
                          guidance_scale: float, axis: str = "time", window: int = 8,
                          stride: int = 6, compute_dtype: Optional[torch.dtype] = None,
                          propagation_steps: Sequence[int] = (), pab=None):
    """``denoise(latents, image_noised, prompt_embeds, denoise_level[, flows_f,
    flows_b]) -> latents`` with every input and the output whole on every
    rank of ``mesh``'s ``axis``; inside, each rank runs the loop on its chunk
    of T / N frames (T / N a multiple of the stride, at least a window) and
    the chunks are gathered at the end (JAX's callable, without its
    parameter argument). latents (B, T, H, W, 4) float32; image_noised
    (CFG·B, T, H, W, 3); prompt_embeds (CFG·B, 77, C); denoise_level
    (CFG·B,). With ``propagation_steps`` x̂0 is propagated along the
    bidirectional flows (B, T-1, Hf, Wf, 2) at those step indices. With
    ``pab`` (a ``PABConfig``) each global window's attention caches live on
    the rank that computes it."""
    group, n_chunks, rank = axis_group(mesh, axis)
    do_cfg = guidance_scale > 1.0
    prop = set(propagation_steps)
    flags = collect = None
    if pab is not None:
        flags = pab.use_cached_flags(num_inference_steps)
        collect = unet.make_pab_collect_cache(
            pab.skip_levels,
            None if set(pab.kinds) == {"spatial", "cross", "temporal"} else pab.kinds)

    @torch.no_grad()
    def denoise(latents, image_noised, prompt_embeds, denoise_level, flows_f=None,
                flows_b=None, tick=None):
        if prop and flows_f is None:
            raise ValueError("propagation steps need flows_f and flows_b")
        t = latents.shape[1]
        if t % n_chunks:
            raise ValueError(f"{t} frames do not split over {n_chunks} ranks")
        t_local = t // n_chunks
        mine = slice(rank * t_local, (rank + 1) * t_local)
        lat, img = latents[:, mine], image_noised[:, mine]
        dtype = compute_dtype or unet.conv_in.weight.dtype
        caches = None
        if pab is not None:
            caches = [collect] * local_window_count(t_local, n_chunks, window, stride)
        for i, tstep in enumerate(scheduler.timesteps(num_inference_steps)):
            tstep = int(tstep)
            latent_in = torch.cat([lat, lat]) if do_cfg else lat

            def win_fn(xs, cache=None):
                lat_w, img_w = xs
                if cache is None:
                    return unet(lat_w.to(dtype), tstep, img_w.to(dtype), prompt_embeds,
                                denoise_level)
                return unet(lat_w.to(dtype), tstep, img_w.to(dtype), prompt_embeds,
                            denoise_level, cache, {k: bool(f[i]) for k, f in flags.items()})

            noise_pred = windowed_apply_local(win_fn, (latent_in, img), n_chunks, window, stride,
                                              caches, group, rank)
            if caches is not None:
                noise_pred, caches = noise_pred
            noise_pred = noise_pred.float()
            if do_cfg:
                uncond, cond = noise_pred.chunk(2, dim=0)
                noise_pred = uncond + guidance_scale * (cond - uncond)
            x0 = scheduler.step_v0(noise_pred, tstep, lat)
            if i in prop:
                x0 = distributed_propagate_latents(x0, flows_f, flows_b, n_chunks, group, rank)
            lat = scheduler.step_vt(x0, noise_pred, tstep, lat, num_inference_steps)
            if tick is not None:
                tick(i)
        parts = all_gather(lat, n_chunks, group)  # (N, B, T_local, ...)
        return parts.movedim(0, 1).flatten(1, 2)

    return denoise


def shard_video(x: torch.Tensor, mesh, axis: str = "time"):
    """A (B, T, ...) tensor as a ``DTensor`` on ``mesh`` with the frame axis
    split over ``axis`` (``Shard(1)``) and replicated over any other axis."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    axis_group(mesh, axis)
    return distribute_tensor(x, mesh, [Shard(1) if name == axis else Replicate()
                                       for name in mesh.mesh_dim_names])
