"""Training of the port's models (mirror of ``upscale_a_video_tpu/training``):
the UNet's temporal finetune, the conditional VAE's GAN losses, LoRA and
the captioner's finetune, the degradation pipeline and the schedules."""

from .train_unet import diffusion_loss, init_optimizer, make_train_step, temporal_param_mask

__all__ = ["make_train_step", "diffusion_loss", "temporal_param_mask", "init_optimizer"]
