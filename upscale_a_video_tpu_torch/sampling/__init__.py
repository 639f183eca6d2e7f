from .ddim import DDIMScheduler, DDIMSchedulerConfig
from .ddpm import DDPMScheduler, DDPMSchedulerConfig

__all__ = ["DDIMScheduler", "DDIMSchedulerConfig", "DDPMScheduler", "DDPMSchedulerConfig"]
