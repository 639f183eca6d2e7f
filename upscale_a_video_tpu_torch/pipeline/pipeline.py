"""VideoUpscalePipeline: CLIP prompt encoding → LR noising → windowed CFG
DDIM denoise with the split step → chunked fp32 VAE decode.

Mirror of ``upscale_a_video_tpu/pipeline/pipeline.py`` (``__call__`` at
``:497-597``) without its TPU execution machinery: the steps are a Python
loop, each step runs the UNet once on all unique 8-frame windows (CFG rows
share the text-free prefix, ``cfg_dup``), blends them with the window matrix
and takes ``step_v0`` then ``step_vt``. The ``latents`` and ``lr_noise``
arguments let a caller hand both frameworks identical noise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..config import UNetVideoConfig, VaeConfig, resolve_device
from ..models import AutoencoderKLVideo, CLIPTextConfig, CLIPTextModel, UNetVideoModel
from ..sampling import DDIMScheduler, DDIMSchedulerConfig, DDPMScheduler
from ..weights import init_random_
from .windows import chunk_starts, unique_window_plan


@dataclasses.dataclass
class PipelineModules:
    """``tokenizer`` maps a list of prompts to int (B, 77) token ids."""

    unet: UNetVideoModel
    vae: AutoencoderKLVideo
    text_encoder: CLIPTextModel
    tokenizer: Any
    scheduler: DDIMScheduler
    low_res_scheduler: DDPMScheduler


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

    def __init__(self, modules: PipelineModules, device=None):
        self.m = modules
        self.device = resolve_device(device)

    @property
    def dtype(self) -> torch.dtype:
        return self.m.unet.conv_in.weight.dtype

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
    def unet_on_windows(self, lat, image_noised, tstep, prompt_embeds, level, do_cfg):
        """lat/image_noised: (B, T, h, w, C) → blended noise prediction
        (2B if do_cfg else B, T, h, w, 4), fp32."""
        b, t, h, w, _ = lat.shape
        ustarts, blend = unique_window_plan(t, self.WINDOW, self.STRIDE)
        win = min(self.WINDOW, t)
        n = len(ustarts)
        idx = torch.as_tensor(np.asarray(ustarts)[:, None] + np.arange(win)[None, :],
                              device=lat.device)
        gather = lambda v: v[:, idx].transpose(0, 1).reshape(n * b, win, h, w, v.shape[-1])
        lw = gather(lat.to(self.dtype))
        iw = gather(image_noised)
        if do_cfg:
            u, c = prompt_embeds.chunk(2, dim=0)
            emb = torch.cat([u.repeat(n, 1, 1), c.repeat(n, 1, 1)])
        else:
            emb = prompt_embeds.repeat(n, 1, 1)
        lvl = level.repeat(n)
        out = self.m.unet(lw, tstep, iw, emb, lvl, cfg_dup=do_cfg).float()
        rows = 2 * b if do_cfg else b
        if do_cfg:  # (2, n, b, ...) halves → per window [uncond b, cond b]
            out = out.reshape(2, n, b, win, h, w, -1).transpose(0, 1)
        out = out.reshape(n, rows, win, h, w, -1)
        blend_t = torch.as_tensor(blend, device=lat.device)
        return torch.einsum("nkt,nbkhwc->bthwc", blend_t, out)

    # ----------------------------------------------------------- decode
    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Chunked decode (ref :683-702), clipped to [-1, 1]."""
        vae = self.m.vae
        outs = []
        for s, e in chunk_starts(latents.shape[1], self.DECODE_CHUNK):
            z = latents[:, s:e] / vae.config.scaling_factor
            outs.append(vae.decode(z).float().clamp(-1.0, 1.0))
        return torch.cat(outs, dim=1)

    def check_inputs(self, prompt, image, noise_level, negative_prompt):
        if prompt is not None and not isinstance(prompt, (str, list)):
            raise ValueError(f"`prompt` must be str or list, got {type(prompt)}")
        if getattr(image, "ndim", None) != 5 or image.shape[-1] != 3:
            raise ValueError(f"`image` must be (B, T, H, W, 3), got "
                             f"{getattr(image, 'shape', None)}")
        if noise_level > self.MAX_NOISE_LEVEL:
            raise ValueError(f"`noise_level` has to be <= {self.MAX_NOISE_LEVEL}")
        if isinstance(prompt, list) and image.shape[0] != len(prompt):
            raise ValueError(f"batch mismatch: {len(prompt)} prompts vs {image.shape[0]} clips")

    # --------------------------------------------------------- __call__
    @torch.no_grad()
    def __call__(self, prompt, image, num_inference_steps: int = 30,
                 guidance_scale: float = 6.0, noise_level: int = 120, negative_prompt=None,
                 generator: Optional[torch.Generator] = None, latents=None, lr_noise=None):
        """image: (B, T, H, W, 3) in [-1, 1] → (B, T, 4H, 4W, 3) fp32 in [-1, 1]."""
        self.check_inputs(prompt, image, noise_level, negative_prompt)
        prompt = [prompt] if isinstance(prompt, str) else prompt
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt]
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(10)
        image = torch.as_tensor(image, device=dev).float()
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

        sched = self.m.scheduler
        for tstep in sched.timesteps(num_inference_steps):
            tstep = int(tstep)
            pred = self.unet_on_windows(lat, image_noised, tstep, prompt_embeds, level, do_cfg)
            if do_cfg:
                uncond, cond = pred.chunk(2, dim=0)
                pred = uncond + guidance_scale * (cond - uncond)
            x0 = sched.step_v0(pred, tstep, lat)
            lat = sched.step_vt(x0, pred, tstep, lat, num_inference_steps)
        return self.decode_latents(lat)


def random_pipeline(device=None, seed: int = 0, unet_config: UNetVideoConfig = UNetVideoConfig(),
                    vae_config: VaeConfig = VaeConfig(),
                    clip_config: CLIPTextConfig = CLIPTextConfig(),
                    dtype: torch.dtype = torch.bfloat16,
                    decode_dtype: torch.dtype = torch.float32) -> VideoUpscalePipeline:
    """The main path as ``bench.py:build_pipeline`` drives the reference, with
    random weights drawn on the target device from a seeded generator: UNet
    and CLIP in ``dtype``, the VAE in ``decode_dtype``, DDIM with scaled-linear
    betas and a DDPM low-res scheduler, the fixed-token tokenizer."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(cls, cfg, dt):
        with torch.device("meta"):
            m = cls(cfg)
        m = init_random_(m.to_empty(device=dev), gen)
        return m.to(dt).eval()

    modules = PipelineModules(
        unet=make(UNetVideoModel, unet_config, dtype),
        vae=make(AutoencoderKLVideo, vae_config, decode_dtype),
        text_encoder=make(CLIPTextModel, clip_config, dtype),
        tokenizer=FixedTokenizer(),
        scheduler=DDIMScheduler(DDIMSchedulerConfig(beta_schedule="scaled_linear")),
        low_res_scheduler=DDPMScheduler())
    return VideoUpscalePipeline(modules, device=dev)
