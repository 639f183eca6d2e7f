"""UNet training step: temporal-adapter finetuning (mirror of
``upscale_a_video_tpu/training/train_unet.py``).

The ε-prediction MSE of the ×4 upscaler over video latents, with AdamW over
the temporal parameters only (the reference's ``from_pretrained_2d``
freezing scheme, unet_video.py:577-601): every other parameter gets
``requires_grad=False`` and no optimizer state, as JAX's
``multi_transform``/``set_to_zero`` leaves it unchanged.

Precision: a UNet kept in bf16 (the card, where the kernels' gates take bf16
only) trains fp32 master copies of its trainable parameters, which the
optimizer updates and which are copied back after each step; JAX computes in
bf16 from fp32 parameters the same way (``dtype=bf16``,
``param_dtype=float32``). An fp32 UNet is its own master.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

TEMPORAL_KEYS = ("temp_block", "temp_blocks", "attn_temporal", "norm_temporal",
                 "resblock_temporal", "resblocks_3d")


def is_temporal(name: str) -> bool:
    """A parameter of a temporal module: some segment of its dotted name
    holds one of :data:`TEMPORAL_KEYS` (JAX tests the flax path's segments)."""
    return any(key in seg for seg in name.split(".") for key in TEMPORAL_KEYS)


def temporal_param_mask(unet: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: trainable}: True for the temporal parameters, the
    trainable set under the reference's freezing scheme."""
    return {name: is_temporal(name) for name, _ in unet.named_parameters()}


def draw_noise(latents: torch.Tensor, low_res: torch.Tensor, num_train_timesteps: int,
               max_noise_level: int, generator: Optional[torch.Generator] = None):
    """The draws of :func:`diffusion_loss` (JAX ``train_unet.py:58-64``):
    timesteps t (B,), the latent noise eps, noise levels lvl (B,) and the LR
    frames' noise lr_noise."""
    b, dev = latents.shape[0], latents.device
    return {"t": torch.randint(0, num_train_timesteps, (b,), generator=generator, device=dev),
            "eps": torch.randn(latents.shape, generator=generator, device=dev,
                               dtype=latents.dtype),
            "lvl": torch.randint(0, max_noise_level, (b,), generator=generator, device=dev),
            "lr_noise": torch.randn(low_res.shape, generator=generator, device=dev,
                                    dtype=low_res.dtype)}


def diffusion_loss(unet, batch: Dict[str, torch.Tensor], scheduler, low_res_scheduler,
                   max_noise_level: int = 350, noise: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """ε-prediction MSE for the ×4-upscaler objective, fp32.

    batch: ``latents`` (B, T, h, w, 4) clean scaled latents, ``low_res``
    (B, T, h, w, 3) LR frames in [-1, 1], ``text_embeds`` (B, S, C).
    ``noise`` (the keys of :func:`draw_noise`) replaces the draws from
    ``generator``: the LR frames are noised at a random level, as at
    inference."""
    latents, low_res = batch["latents"], batch["low_res"]
    if noise is None:
        noise = draw_noise(latents, low_res, scheduler.config.num_train_timesteps,
                           max_noise_level, generator)
    t, eps, lvl = noise["t"], noise["eps"], noise["lvl"]
    noisy = scheduler.add_noise(latents, eps, t)
    low_res_noised = low_res_scheduler.add_noise(low_res, noise["lr_noise"], lvl)
    pred = unet(noisy, t, low_res_noised, batch["text_embeds"], lvl)
    return torch.mean(torch.square(pred.float() - eps.float()))


def default_optimizer(params) -> torch.optim.Optimizer:
    """``optax.adamw(1e-4, weight_decay=1e-2)``: betas (0.9, 0.999), eps 1e-8,
    decoupled decay on every trained parameter."""
    return torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)


@dataclasses.dataclass
class TrainState:
    """The optimizer and its (parameter, master) pairs: ``master`` is the
    parameter itself when it is fp32, else its fp32 copy that the optimizer
    updates."""

    optimizer: torch.optim.Optimizer
    pairs: List[Tuple[torch.nn.Parameter, torch.Tensor]]

    def zero_grad(self) -> None:
        for p, m in self.pairs:
            p.grad = None
            m.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One optimizer step on the gradients the parameters hold, then the
        masters copied back into the parameters."""
        for p, m in self.pairs:
            if m is not p:
                m.grad = None if p.grad is None else p.grad.float()
        self.optimizer.step()
        for p, m in self.pairs:
            if m is not p:
                p.copy_(m)
        self.zero_grad()


def init_optimizer(unet: torch.nn.Module, optimizer: Optional[Callable] = None,
                   freeze_non_temporal: bool = True) -> TrainState:
    """Freeze the non-temporal parameters (``requires_grad=False``, no
    optimizer state) and build ``optimizer(masters)`` (default
    :func:`default_optimizer`) over fp32 masters of the rest."""
    make = optimizer or default_optimizer
    pairs = []
    for name, p in unet.named_parameters():
        train = is_temporal(name) or not freeze_non_temporal
        p.requires_grad_(train)
        if train:
            m = p if p.dtype == torch.float32 else p.detach().float().clone()
            pairs.append((p, m))
    return TrainState(make([m for _, m in pairs]), pairs)


def make_train_step(unet, scheduler, low_res_scheduler, state: TrainState,
                    max_noise_level: int = 350) -> Callable:
    """``train_step(batch, noise=None, generator=None) -> loss``: the loss
    of :func:`diffusion_loss`, its backward and one step of ``state``
    (:func:`init_optimizer`). Returns the loss, detached."""

    def train_step(batch, noise=None, generator=None):
        state.zero_grad()
        loss = diffusion_loss(unet, batch, scheduler, low_res_scheduler, max_noise_level,
                              noise, generator)
        loss.backward()
        state.step()
        return loss.detach()

    return train_step
