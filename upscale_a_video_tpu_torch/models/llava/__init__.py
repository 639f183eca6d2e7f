"""The LLaVA captioner (mirror of ``upscale_a_video_tpu/models/llava``)."""

from .llava import LlavaCaptioner, LlavaConfig, LlavaModel
from .mpt import MPTConfig, MPTForCausalLM

__all__ = ["LlavaCaptioner", "LlavaConfig", "LlavaModel", "MPTConfig", "MPTForCausalLM"]
