"""Conditional-VAE decoder finetuning losses (mirror of
``upscale_a_video_tpu/training/train_vae.py``; ref
autoencoder_kl_cond_video.py:363-389 ``training_losses``).

- ``optimizer_idx`` 0, the generator: L1 reconstruction plus the weighted
  generator-adversarial term of a PatchGAN;
- ``optimizer_idx`` 1, the discriminator: the hinge loss on real frames and
  on the reconstruction, which is computed without autograd (JAX's
  ``stop_gradient``), so the VAE gets no gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import GroupNorm


class PatchDiscriminator(nn.Module):
    """70×70-receptive-field PatchGAN over frames, channels last:
    (N, H, W, 3) → (N, h', w', 1) patch logits. Its parameters carry the
    flax module's names (``conv_in``, ``conv.i``, ``norm.i``, ``conv_out``),
    so ``weights.discriminator_state_dict`` converts a JAX tree."""

    def __init__(self, base_channels: int = 64, num_layers: int = 3):
        super().__init__()
        ch = base_channels
        self.conv_in = nn.Conv2d(3, ch, 4, stride=2, padding=1)
        self.conv, self.norm = nn.ModuleDict(), nn.ModuleDict()
        for i in range(1, num_layers + 1):
            prev, ch = ch, min(base_channels * 2 ** i, 512)
            self.conv[str(i)] = nn.Conv2d(prev, ch, 4, stride=2 if i < num_layers else 1,
                                          padding=1, bias=False)
            self.norm[str(i)] = GroupNorm(min(32, ch), ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 1, 4, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv_in(x.permute(0, 3, 1, 2)), 0.2)
        for i in self.conv:
            h = self.conv[i](h).permute(0, 2, 3, 1)
            h = F.leaky_relu(self.norm[i](h), 0.2).permute(0, 3, 1, 2)
        return self.conv_out(h).permute(0, 2, 3, 1)


def hinge_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - real_logits).mean() + F.relu(1.0 + fake_logits).mean())


def vae_training_losses(vae, disc: PatchDiscriminator, inputs: Optional[torch.Tensor],
                        gts: torch.Tensor, latents: torch.Tensor, optimizer_idx: int,
                        disc_weight: float = 0.5,
                        disc_start_weight_on: Optional[torch.Tensor] = None,
                        w_lr: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, recon) for ``optimizer_idx`` 0 (generator) or 1
    (discriminator). inputs: (B, T, h, w, 3) LR condition frames or None;
    gts: (B, T, 4h, 4w, 3); latents: (B, T, h, w, 4), scaled."""
    z = latents / vae.config.scaling_factor
    flat = lambda a: a.reshape(-1, *a.shape[2:])
    if optimizer_idx == 0:
        recon = vae.decode(z, inputs, w_lr)
        rec_flat = flat(recon).float()
        rec_loss = (rec_flat - flat(gts).float()).abs().mean()
        g_loss = -disc(rec_flat).mean()
        gate = 1.0 if disc_start_weight_on is None else disc_start_weight_on
        return rec_loss + disc_weight * gate * g_loss, recon
    if optimizer_idx != 1:
        raise ValueError(f"optimizer_idx must be 0 or 1, got {optimizer_idx}")
    with torch.no_grad():
        recon = vae.decode(z, inputs, w_lr)
    real = disc(flat(gts).float())
    fake = disc(flat(recon).float())
    return hinge_d_loss(real, fake), recon
