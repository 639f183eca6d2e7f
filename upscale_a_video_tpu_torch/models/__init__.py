from .clip_text import CLIPTextConfig, CLIPTextModel
from .unet_video import UNetVideoModel
from .vae import AutoencoderKLVideo

__all__ = ["AutoencoderKLVideo", "CLIPTextConfig", "CLIPTextModel", "UNetVideoModel"]
