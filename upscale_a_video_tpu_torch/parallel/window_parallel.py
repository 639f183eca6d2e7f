"""Window-parallel denoise: the UNet's temporal windows spread over ranks
(port of ``upscale_a_video_tpu/parallel/window_parallel.py``).

The temporal-chunk scheme (``temporal.py``) needs ``T / N`` frames a rank to
hold a window at least, which short clips on many ranks do not. This module
shares out the work items instead: the reference's sliding-window plan
(ref pipeline_upscale_a_video.py:601-635) gives ``n_win`` windows a step,
each on the CFG·B batch, a (window × batch row) grid of independent UNet
calls that the single-device pipeline batches through one blend matrix
(``pipeline/windows.py``). Here that item axis is split over the ranks:

- the latents are whole on every rank (small next to the UNet's
  activations);
- each rank gathers its items' frames, runs the UNet on its item batch and
  contracts its predictions with its slice of the blend matrix, as the
  single-device pipeline contracts all of them;
- one all-reduce (JAX's ``psum``) rebuilds the blended noise prediction on
  every rank;
- the DDIM split step (and the flow propagation on its steps) runs on every
  rank, element-wise work far cheaper than any exchange that would avoid it.

An item is a (window, clip) pair with both of its CFG rows, which share the
UNet's text-free prefix as in the port's single-device pipeline (JAX's item
is one CFG row). Items are padded to a multiple of the rank count with
zero-weight dummies, so any T and any rank count work, and every rank
issues the same collectives in the same order. On one rank the call is the
single-device pipeline's, bit for bit; over several, the partial blends
are summed in another order: the two agree to float32 rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.propagation import propagate_latents
from ..pipeline.windows import unique_window_plan
from .mesh import all_reduce_sum, axis_group


def _item_plan(num_frames: int, batch: int, n_dev: int, window: int, stride: int):
    """Static item tables: item i = (window i // batch, batch row i % batch),
    padded with zero-weight dummies to a multiple of ``n_dev``. Returns
    (win, item_start (P,), item_b (P,), item_blend (P, win, T), onehot_b
    (P, batch)) as numpy arrays (JAX ``window_parallel.py:40-65``)."""
    # the deduplicated plan: repeated tail windows collapse onto one item
    ustarts, blend = unique_window_plan(num_frames, window, stride)
    starts = np.asarray(ustarts)
    win = blend.shape[1]
    n_items = len(starts) * batch
    padded = -(-n_items // n_dev) * n_dev

    item_start = np.zeros(padded, np.int32)
    item_b = np.zeros(padded, np.int32)
    item_blend = np.zeros((padded, win, num_frames), np.float32)
    onehot = np.zeros((padded, batch), np.float32)
    for i in range(n_items):
        n, bi = divmod(i, batch)
        item_start[i] = starts[n]
        item_b[i] = bi
        item_blend[i] = blend[n]
        onehot[i, bi] = 1.0
    return win, item_start, item_b, item_blend, onehot


def build_window_sharded_denoise(unet, scheduler, mesh, num_inference_steps: int,
                                 guidance_scale: float, num_frames: int, batch: int = 1,
                                 axis: str = "win", window: int = 8, stride: int = 6,
                                 compute_dtype: Optional[torch.dtype] = None,
                                 propagation_steps: Sequence[int] = (), pab=None):
    """``denoise(latents, image_noised, prompt_embeds, denoise_level[, flows_f,
    flows_b], tick=None) -> latents``, every input and the output whole on
    every rank of ``mesh``'s ``axis``, the window items of each step split
    over those ranks (JAX's callable, without its parameter argument: the
    UNet holds its weights). latents (B, T, H, W, 4) float32; image_noised
    (CFG·B, T, H, W, 3); prompt_embeds (CFG·B, 77, C) as [uncond, cond];
    denoise_level (CFG·B,). ``compute_dtype`` (the UNet's dtype by default)
    is what the UNet takes. With ``propagation_steps``, x̂0 is propagated
    along ``flows_f``/``flows_b`` at those step indices; ``tick(i)`` runs
    after step i. On the card the UNet runs the hand-written kernels.

    An item is a (window, clip) pair with both CFG rows: the rank runs them
    through the UNet with the text-free prefix shared (``cfg_dup``), as the
    port's single-device pipeline always does, where JAX's items are single
    CFG rows. So one rank's call is the single-device pipeline's batched
    call, operation for operation.

    ``pab`` (a ``pipeline.PABConfig``): Pyramid Attention Broadcast with
    each rank holding the attention-delta caches of its own items only.
    Items stay with their rank across steps, and each cache sees the states
    the single-device batched run gives that item, so the result is the
    single-device PAB's (PAB itself approximates the exact loop)."""
    group, n_dev, rank = axis_group(mesh, axis)
    do_cfg = guidance_scale > 1.0
    win, item_start, item_b, item_blend, onehot = _item_plan(num_frames, batch, n_dev, window,
                                                             stride)
    ipd = len(item_start) // n_dev  # items per rank
    mine = slice(rank * ipd, (rank + 1) * ipd)
    prop = set(propagation_steps)
    flags = cache0 = None
    if pab is not None:
        flags = pab.use_cached_flags(num_inference_steps)
        kinds = None if set(pab.kinds) == {"spatial", "cross", "temporal"} else pab.kinds
        cache0 = unet.make_pab_collect_cache(pab.skip_levels, kinds)
    tables = {}

    def on(device):
        """This rank's item tables on ``device``, copied there once."""
        if device not in tables:
            frame_idx = item_start[mine, None] + np.arange(win)[None, :]  # (ipd, win)
            tables[device] = tuple(torch.as_tensor(a, device=device) for a in (
                item_b[mine], frame_idx, item_blend[mine], onehot[mine]))
        return tables[device]

    @torch.no_grad()
    def denoise(latents, image_noised, prompt_embeds, denoise_level, flows_f=None,
                flows_b=None, tick=None):
        if latents.shape[1] != num_frames:
            raise ValueError(f"built for {num_frames} frames, given {latents.shape[1]}")
        if prop and flows_f is None:
            raise ValueError("propagation steps need flows_f and flows_b")
        my_b, frame_idx, my_blend, my_onehot = on(latents.device)
        dtype = compute_dtype or unet.conv_in.weight.dtype
        halves = 2 if do_cfg else 1  # the CFG rows of one item: [uncond, cond]
        # the UNet's context and labels in the pipeline's row order: every
        # item's uncond row, then every item's cond row
        emb = torch.cat([prompt_embeds[h * batch:(h + 1) * batch][my_b] for h in range(halves)])
        lvl_items = denoise_level[:batch][my_b]
        img_items = image_noised[:batch][my_b[:, None], frame_idx]  # (ipd, win, H, W, 3)
        lat, cache = latents, cache0
        for i, tstep in enumerate(scheduler.timesteps(num_inference_steps)):
            tstep = int(tstep)
            lat_items = lat.to(dtype)[my_b[:, None], frame_idx]
            if cache is None:
                preds = unet(lat_items, tstep, img_items, emb, lvl_items, cfg_dup=do_cfg)
            else:
                preds, cache = unet(lat_items, tstep, img_items, emb, lvl_items, cache,
                                    {kind: bool(f[i]) for kind, f in flags.items()},
                                    cfg_dup=do_cfg)
            # (ipd, halves·B, win, ...): each item's rows at its clip's place,
            # zero elsewhere; then this rank's share of the blend, and one sum
            # over the ranks
            preds = preds.float().reshape((halves, ipd, 1) + tuple(preds.shape[1:]))
            rows = (preds.transpose(0, 1) * my_onehot[:, None, :, None, None, None, None])
            rows = rows.reshape((ipd, halves * batch) + tuple(preds.shape[3:]))
            part = torch.einsum("nkt,nbkhwc->bthwc", my_blend, rows)
            noise_pred = all_reduce_sum(part, group)
            if do_cfg:
                uncond, cond = noise_pred.chunk(2, dim=0)
                noise_pred = uncond + guidance_scale * (cond - uncond)
            x0 = scheduler.step_v0(noise_pred, tstep, lat)
            if i in prop:
                x0 = propagate_latents(x0, flows_f, flows_b)
            lat = scheduler.step_vt(x0, noise_pred, tstep, lat, num_inference_steps)
            if tick is not None:
                tick(i)
        return lat

    return denoise
