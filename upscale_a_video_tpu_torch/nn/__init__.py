"""Channels-last ``(B, T, H, W, C)`` building blocks of the UNet and the VAE."""
