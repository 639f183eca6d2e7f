"""VideoUpscalePipeline: CLIP prompt encoding → LR noising → windowed CFG
DDIM denoise with the split step → chunked VAE decode (conditioned on the
fp32 LR frames with weight ``w_lr`` when the VAE is the video VAE).

Mirror of ``upscale_a_video_tpu/pipeline/pipeline.py`` (``__call__`` at
``:497-597``, same argument order). Each denoise step runs the UNet on the
unique 8-frame windows, all in one call or ``window_group`` at a time (CFG
rows share the text-free prefix, ``cfg_dup``), blends them with the window
matrix and takes ``step_v0``, then, at the step indices in
``propagation_steps`` when bidirectional flows are given, propagates x̂0
along them (``-p``, ref ``:330-339``), then takes ``step_vt``. With a
:class:`PABConfig` the attention deltas are broadcast across steps.
``step_mode`` as in JAX: ``"host"`` issues each step from the host with a
progress tick per step; ``"scan"`` (the default) runs the whole loop as one
CUDA graph on the card once its key comes back (``graphs.py``; a key's
first call runs eagerly) and eagerly on the CPU, with one tick at the end. The ``latents`` and ``lr_noise`` arguments let a caller
hand both frameworks identical noise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import UNetVideoConfig, VaeConfig, resolve_device
from ..models import AutoencoderKLVideo, CLIPTextConfig, CLIPTextModel, UNetVideoModel
from ..models.propagation import propagate_latents
from ..models.raft import RaftRunner
from ..ops import _cuda
from ..sampling import DDIMScheduler, DDIMSchedulerConfig, DDPMScheduler
from ..weights import init_random_
from .graphs import LoopGraphs, weights_stamp
from .windows import chunk_starts, unique_window_plan


@dataclasses.dataclass(frozen=True)
class PABConfig:
    """Pyramid Attention Broadcast (JAX ``pipeline/pipeline.py:40-80``):
    reuse attention deltas across denoise steps. ``*_range`` = recompute
    every N steps inside [start_step, end_step); outside that window
    everything is computed. ``skip_levels`` names UNet levels whose blocks
    recompute every step; ``kinds`` the attention kinds that are cached."""

    cross_range: int = 6
    spatial_range: int = 2
    temporal_range: int = 4
    start_step: int = 2
    end_step: int = 10**9
    skip_levels: Tuple[str, ...] = ()
    kinds: Tuple[str, ...] = ("spatial", "cross", "temporal")

    def use_cached_flags(self, num_steps: int):
        """(steps,) bool arrays per attention kind: True = reuse the cache."""
        steps = np.arange(num_steps)
        inside = (steps >= self.start_step) & (steps < self.end_step)

        def sched(rng):
            if rng <= 1:
                return np.zeros(num_steps, dtype=bool)
            recompute = (steps - self.start_step) % rng == 0
            return inside & ~recompute

        return {"cross": sched(self.cross_range), "spatial": sched(self.spatial_range),
                "temporal": sched(self.temporal_range)}


@functools.lru_cache(maxsize=16)
def _window_tensors(t: int, window: int, stride: int, device: torch.device):
    """The unique windows' frame indices (N, win) and the blend matrix on
    ``device``, copied there once per clip length (not inside the loop)."""
    ustarts, blend = unique_window_plan(t, window, stride)
    idx = np.asarray(ustarts)[:, None] + np.arange(min(window, t))[None, :]
    return torch.as_tensor(idx, device=device), torch.as_tensor(blend, device=device)


@dataclasses.dataclass
class PipelineModules:
    """``tokenizer`` maps a list of prompts to int (B, 77) token ids;
    ``raft`` is the flow model of the propagation path, where one was
    loaded."""

    unet: UNetVideoModel
    vae: AutoencoderKLVideo
    text_encoder: CLIPTextModel
    tokenizer: Any
    scheduler: DDIMScheduler
    low_res_scheduler: DDPMScheduler
    raft: Optional[RaftRunner] = None


class FixedTokenizer:
    """BOS then EOS padding for every prompt: the released BPE vocabulary is
    not in the repository (as ``bench.py`` drives the reference)."""

    def __call__(self, prompts):
        ids = np.full((len(prompts), 77), 49407, dtype=np.int64)
        ids[:, 0] = 49406
        return ids


class VideoUpscalePipeline:
    MAX_NOISE_LEVEL = 350
    WINDOW, STRIDE = 8, 6  # UNet frame windows (ref :601-635)
    DECODE_CHUNK = 3       # frames per VAE decode (ref :685-700)

    def __init__(self, modules: PipelineModules, device=None, pab: Optional[PABConfig] = None,
                 step_mode: str = "scan"):
        if step_mode not in ("scan", "host"):
            raise ValueError(f"step_mode must be 'scan' or 'host', got {step_mode!r}")
        self.m = modules
        self.device = resolve_device(device)
        self.pab = pab
        self.step_mode = step_mode
        self.graphs = LoopGraphs()  # "scan" on the card: the captured loop
        # 0 runs every unique window in one UNet call; G > 0 runs them G at a
        # time when G divides their count and is smaller (else in one call,
        # as the JAX pipeline decides). The CLI sets 1 for clips over 8 frames.
        self.window_group = 0
        self._offload = False
        self.propagated_steps: Tuple[int, ...] = ()  # step indices of the last call

    @property
    def dtype(self) -> torch.dtype:
        return self.m.unet.conv_in.weight.dtype

    # ---------------------------------------------------------- offload
    def enable_model_offload(self, enabled: bool = True) -> None:
        """Keep the UNet and VAE weights in host memory and move each to the
        device only for its own stage (denoise, decode), which it leaves
        afterwards (JAX ``:152-171``); the text encoder stays on the device.
        ``enabled=False`` brings both back to stay."""
        self._offload = enabled
        for module in (self.m.unet, self.m.vae):
            self._move(module, torch.device("cpu") if enabled else self.device)

    def _move(self, module: torch.nn.Module, device: torch.device) -> None:
        _cuda.drop_cached(module)  # kernel operands made from the weights stay behind otherwise
        self.graphs.clear()  # a graph would read the old storage
        module.to(device)

    @contextlib.contextmanager
    def _stage(self, module: torch.nn.Module):
        if not self._offload:
            yield
            return
        self._move(module, self.device)
        try:
            yield
        finally:
            self._move(module, torch.device("cpu"))

    def _tick(self, progress_cb, stage: str, done: int, total: int) -> None:
        """``progress_cb(stage, done, total)``, if given, once the card has
        finished the work it reports (no sync without a callback)."""
        if progress_cb is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            progress_cb(stage, done, total)

    # ------------------------------------------------------------- text
    @torch.no_grad()
    def encode_prompt(self, prompt: Sequence[str], negative_prompt, do_cfg: bool) -> torch.Tensor:
        """CLIP-encode; with CFG the batch is [uncond, cond]."""
        enc = lambda p: self.m.text_encoder(
            torch.as_tensor(self.m.tokenizer(list(p)), device=self.device))
        cond = enc(prompt)
        if not do_cfg:
            return cond
        neg = negative_prompt if negative_prompt is not None else [""] * len(prompt)
        return torch.cat([enc(neg), cond], dim=0)

    # ---------------------------------------------------------- denoise
    @torch.no_grad()
    def unet_on_windows(self, lat, image_noised, tstep, prompt_embeds, level, do_cfg,
                        attn_cache=None, use_flags=None):
        """lat/image_noised: (B, T, h, w, C) → blended noise prediction
        (2B if do_cfg else B, T, h, w, 4), fp32; with ``attn_cache`` (PAB,
        every window in one call), also the UNet's new caches."""
        bc, t, h, w, _ = lat.shape
        rows = 2 * bc if do_cfg else bc
        idx, blend_t = _window_tensors(t, self.WINDOW, self.STRIDE, lat.device)
        n, win = idx.shape
        group = self.window_group if self.window_group > 0 else n
        if not (n % group == 0 and n > group):
            group = n
        if do_cfg:  # [uncond x (group·bc), cond x (group·bc)], cfg_dup's duplication order
            u, c = prompt_embeds.chunk(2, dim=0)
            emb = torch.cat([u.repeat(group, 1, 1), c.repeat(group, 1, 1)])
        else:
            emb = prompt_embeds.repeat(group, 1, 1)
        lat = lat.to(self.dtype)
        outs = []
        for g0 in range(0, n, group):  # window-major rows: window k's bc rows together
            gather = lambda v: v[:, idx[g0:g0 + group]].transpose(0, 1).reshape(
                group * bc, win, h, w, v.shape[-1])
            out = self.m.unet(gather(lat), tstep, gather(image_noised), emb,
                              level.repeat(group), attn_cache, use_flags, cfg_dup=do_cfg)
            if attn_cache is not None:
                out, attn_cache = out
            out = out.float()
            if do_cfg:  # (2, group, bc, ...) halves → per window [uncond bc, cond bc]
                out = out.reshape(2, group, bc, win, h, w, -1).transpose(0, 1)
            outs.append(out.reshape(group, rows, win, h, w, -1))
        pred = torch.einsum("nkt,nbkhwc->bthwc", blend_t, torch.cat(outs))
        return pred if attn_cache is None else (pred, attn_cache)

    @torch.no_grad()
    def denoise(self, lat, image_noised, prompt_embeds, level, flows_f, flows_b, *,
                num_inference_steps: int, guidance_scale: float, propagation_steps=(),
                tick=None) -> torch.Tensor:
        """The DDIM loop (JAX ``make_body``, ``:327-364``) from the scaled
        initial latents ``lat``: ``propagation_steps`` propagate x̂0 along
        ``flows_f``/``flows_b``, ``self.pab`` broadcasts the attention
        deltas on its steps, and ``tick(i)`` runs after step i. Every choice
        of a step is made on the host, so the whole loop can be captured."""
        sched = self.m.scheduler
        do_cfg = guidance_scale > 1.0
        flags, cache = {}, None
        if self.pab is not None:
            flags = self.pab.use_cached_flags(num_inference_steps)
            kinds = None if set(self.pab.kinds) == {"spatial", "cross", "temporal"} \
                else self.pab.kinds
            cache = self.m.unet.make_pab_collect_cache(self.pab.skip_levels, kinds)
        for i, tstep in enumerate(sched.timesteps(num_inference_steps)):
            tstep = int(tstep)
            if cache is None:
                pred = self.unet_on_windows(lat, image_noised, tstep, prompt_embeds, level,
                                            do_cfg)
            else:
                pred, cache = self.unet_on_windows(
                    lat, image_noised, tstep, prompt_embeds, level, do_cfg, cache,
                    {kind: bool(f[i]) for kind, f in flags.items()})
            if do_cfg:
                uncond, cond = pred.chunk(2, dim=0)
                pred = uncond + guidance_scale * (cond - uncond)
            x0 = sched.step_v0(pred, tstep, lat)
            if i in propagation_steps:
                x0 = propagate_latents(x0, flows_f, flows_b)
            lat = sched.step_vt(x0, pred, tstep, lat, num_inference_steps)
            if tick is not None:
                tick(i)
        return lat

    # ----------------------------------------------------------- decode
    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, image_dec: Optional[torch.Tensor] = None,
                       w_lr: float = 1.0, progress_cb=None) -> torch.Tensor:
        """Chunked decode (ref :683-702), clipped to [-1, 1]. A VAE that is
        conditioned on the LR frames takes the matching frames of
        ``image_dec`` (B, T, H, W, 3) with weight ``w_lr``."""
        vae = self.m.vae
        cond = vae.config.condition_img
        if cond and image_dec is None:
            raise ValueError("the VAE is conditioned on the LR frames: pass image_dec")
        outs = []
        chunks = chunk_starts(latents.shape[1], self.DECODE_CHUNK)
        with self._stage(vae):
            for k, (s, e) in enumerate(chunks):
                z = latents[:, s:e] / vae.config.scaling_factor
                img = image_dec[:, s:e] if cond else None
                outs.append(vae.decode(z, img, w_lr).float().clamp(-1.0, 1.0))
                self._tick(progress_cb, "decode", k + 1, len(chunks))
        return torch.cat(outs, dim=1)

    def check_inputs(self, prompt, image, noise_level, negative_prompt):
        """Input validation (JAX ``:474-493``, ref check_inputs :356-418)."""
        if prompt is not None and not isinstance(prompt, (str, list)):
            raise ValueError(f"`prompt` must be str or list, got {type(prompt)}")
        if negative_prompt is not None and not isinstance(negative_prompt, (str, list)):
            raise ValueError(
                f"`negative_prompt` must be str or list, got {type(negative_prompt)}")
        if image is None:
            raise ValueError("`image` input cannot be undefined")
        if getattr(image, "ndim", None) != 5 or image.shape[-1] != 3:
            raise ValueError(f"`image` must be (B, T, H, W, 3), got "
                             f"{getattr(image, 'shape', None)}")
        if noise_level > self.MAX_NOISE_LEVEL:
            raise ValueError(f"`noise_level` has to be <= {self.MAX_NOISE_LEVEL}")
        if isinstance(prompt, list) and image.shape[0] != len(prompt):
            raise ValueError(f"batch mismatch: {len(prompt)} prompts vs {image.shape[0]} clips")

    # --------------------------------------------------------- __call__
    @torch.no_grad()
    def __call__(self, prompt, image, flows_bi=None, num_inference_steps: int = 30,
                 guidance_scale: float = 6.0, noise_level: int = 120, negative_prompt=None,
                 propagation_steps: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None, latents=None, lr_noise=None,
                 w_lr: float = 1.0, return_latents: bool = False, progress_cb=None):
        """image: (B, T, H, W, 3) in [-1, 1] → (B, T, 4H, 4W, 3) fp32 in [-1, 1]
        (with ``return_latents``, also the final fp32 latents before the
        decode). ``flows_bi``: the (forward, backward) flows (B, T-1, H, W, 2)
        of the LR frames; x̂0 is propagated along them after ``step_v0`` at
        each step index in ``propagation_steps``. ``generator`` takes the
        place of the JAX ``key``. ``w_lr`` weighs the LR-frame condition of a
        video VAE's decoder. ``progress_cb(stage, done, total)`` is called
        after each denoise step and each decode chunk, once the card has
        finished it."""
        self.check_inputs(prompt, image, noise_level, negative_prompt)
        if self.pab is not None and self.window_group:
            raise ValueError("PAB requires the single batched-window path (window_group=0)")
        prompt = [prompt] if isinstance(prompt, str) else prompt
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt]
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(10)
        image = torch.as_tensor(image, device=dev).float()
        image_dec = image  # fp32 LR frames for the decoder's condition (ref :542)
        b, t, h, w, _ = image.shape
        do_cfg = guidance_scale > 1.0
        prompt_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg)

        # LR noising at `noise_level` (ref :545-551), on the bf16-rounded frames
        if lr_noise is None:
            lr_noise = torch.randn(image.shape, generator=generator, device=dev)
        noise = torch.as_tensor(lr_noise, device=dev).float()
        image_noised = self.m.low_res_scheduler.add_noise(
            image.to(self.dtype).float(), noise,
            torch.full((b,), noise_level, device=dev)).to(self.dtype)
        level = torch.full((b,), noise_level, device=dev, dtype=torch.long)

        latent_ch = self.m.vae.config.latent_channels
        if latents is None:
            latents = torch.randn((b, t, h, w, latent_ch), generator=generator, device=dev)
        lat = torch.as_tensor(latents, device=dev).float() * self.m.scheduler.init_noise_sigma

        prop = set(propagation_steps) if flows_bi is not None else set()  # ref :556-561
        if prop:
            flows_f, flows_b = (torch.as_tensor(f, device=dev).float() for f in flows_bi)
        else:  # never read; the loop's inputs keep one signature
            flows_f = flows_b = torch.zeros((b, max(t - 1, 1), 1, 1, 2), device=dev)
        n = num_inference_steps
        run = functools.partial(self.denoise, num_inference_steps=n,
                                guidance_scale=guidance_scale, propagation_steps=frozenset(prop))
        inputs = (lat, image_noised, prompt_embeds, level, flows_f, flows_b)
        with self._stage(self.m.unet):
            if self.step_mode == "host":
                lat = run(*inputs, tick=lambda i: self._tick(progress_cb, "denoise", i + 1, n))
            else:
                if dev.type == "cuda":  # the whole loop, one graph (JAX :565-570's key)
                    key = ((b, t, h, w), n, do_cfg, float(guidance_scale),
                           tuple(i in prop for i in range(n)), tuple(flows_f.shape),
                           self.window_group, self.pab, _cuda.kernels_enabled())
                    lat = self.graphs.run(key, weights_stamp(self.m.unet), run, inputs)
                else:
                    lat = run(*inputs)
                self._tick(progress_cb, "denoise", n, n)
        self.propagated_steps = tuple(i for i in range(n) if i in prop)
        images = self.decode_latents(lat, image_dec, w_lr, progress_cb)
        return (images, lat) if return_latents else images


def build_module(cls, config, device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator, state_dict=None) -> torch.nn.Module:
    """``cls(config)`` made on ``meta`` (nothing allocated) and placed on
    ``device`` in float32, filled from ``state_dict`` with ``strict=True`` or,
    without one, by PyTorch's initialisers drawn from ``generator`` on the
    device; then cast to ``dtype``, in eval mode."""
    with torch.device("meta"):
        m = cls(config)
    m = m.to_empty(device=device)
    if state_dict is None:
        init_random_(m, generator)
    else:
        m.load_state_dict(state_dict, strict=True)
    return m.to(dtype).eval()


def random_pipeline(device=None, seed: int = 0, unet_config: UNetVideoConfig = UNetVideoConfig(),
                    vae_config: VaeConfig = VaeConfig(),
                    clip_config: CLIPTextConfig = CLIPTextConfig(),
                    dtype: torch.dtype = torch.bfloat16,
                    decode_dtype: torch.dtype = torch.float32) -> VideoUpscalePipeline:
    """The main path as ``bench.py:build_pipeline`` drives the reference, with
    random weights drawn on the target device from a seeded generator: UNet
    and CLIP in ``dtype``, the VAE in ``decode_dtype``, DDIM with scaled-linear
    betas and a DDPM low-res scheduler, the fixed-token tokenizer.
    ``vae_config=VIDEO_VAE`` gives the README's video-VAE configuration."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    modules = PipelineModules(
        unet=build_module(UNetVideoModel, unet_config, dev, dtype, gen),
        vae=build_module(AutoencoderKLVideo, vae_config, dev, decode_dtype, gen),
        text_encoder=build_module(CLIPTextModel, clip_config, dev, dtype, gen),
        tokenizer=FixedTokenizer(),
        scheduler=DDIMScheduler(DDIMSchedulerConfig(beta_schedule="scaled_linear")),
        low_res_scheduler=DDPMScheduler())
    return VideoUpscalePipeline(modules, device=dev)
