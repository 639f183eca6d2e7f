from .loader import load_pipeline
from .pipeline import PipelineModules, VideoUpscalePipeline, random_pipeline
from .windows import chunk_starts, unique_window_plan, window_blend_matrix, window_starts

__all__ = ["PipelineModules", "VideoUpscalePipeline", "load_pipeline", "random_pipeline",
           "chunk_starts", "unique_window_plan", "window_blend_matrix", "window_starts"]
