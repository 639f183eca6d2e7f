"""Multi-GPU execution on ``torch.distributed`` (port of
``upscale_a_video_tpu/parallel``): one process per rank, NCCL on the card
or gloo on the CPU, the process group started by the caller. The builders
load their modules when first asked for, as the JAX package's do."""

from .mesh import make_mesh, param_partition_spec, shard_params
from .temporal import reference_windowed_apply, sharded_windowed_apply, windowed_apply_local

__all__ = [
    "make_mesh",
    "param_partition_spec",
    "shard_params",
    "reference_windowed_apply",
    "sharded_windowed_apply",
    "windowed_apply_local",
]


def __getattr__(name):
    if name in ("build_sharded_denoise", "shard_video"):
        from . import sharded_pipeline

        return getattr(sharded_pipeline, name)
    if name == "build_window_sharded_denoise":
        from . import window_parallel

        return window_parallel.build_window_sharded_denoise
    if name == "build_sharded_decode":
        from . import decode

        return decode.build_sharded_decode
    if name == "build_sharded_flows":
        from . import flow

        return flow.build_sharded_flows
    if name == "distributed_propagate_latents":
        from . import propagation

        return propagation.distributed_propagate_latents
    if name == "ShardedVideoUpscalePipeline":
        from . import eval_pipeline

        return eval_pipeline.ShardedVideoUpscalePipeline
    raise AttributeError(name)
