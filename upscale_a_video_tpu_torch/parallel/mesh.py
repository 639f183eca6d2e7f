"""Device meshes, sharding rules and the collectives of the parallel package
(port of ``upscale_a_video_tpu/parallel/mesh.py``).

The JAX package runs one program over a mesh of chips; the port runs one
process per rank on ``torch.distributed``: a rank holds ``cuda:{local
rank}`` with NCCL, or the CPU with gloo. The caller starts the process group
(``torch.distributed.init_process_group``); nothing here starts one, and
without one every builder of this package raises instead of running the
single-device path. A builder's ``mesh`` is a ``DeviceMesh`` whose ``axis``
names the ranks it shards over, or None for all ranks of the group.

- ``data`` axis: videos, tiles, CFG rows, window items: no communication.
- ``model`` axis: tensor parallelism over attention heads and MLP or conv
  output channels, expressed only through each parameter's placement
  (:func:`param_partition_spec`, :func:`shard_params`).

The JAX rules name flax kernels: a Dense kernel is (in, out) and a conv
kernel (kh, kw, in, out), where torch keeps ``Linear.weight`` as (out, in)
and a conv weight as (out, in, kh, kw). So JAX's sharded "last axis" is
torch dim 0, and the "first axis" of a row-parallel Dense kernel torch dim
1 (:func:`flax_axis_to_torch`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_NAMES = ("data", "model")

# parameter names whose output axis shards over the model axis (column
# parallel), and those whose input axis does (row parallel): the megatron
# pattern, q/k/v and in-projections column parallel, out-projections row
# parallel (JAX ``mesh.py:80-85``, on flax module names: ``to_out.0`` is
# ``to_out_0`` there)
_COL_PARALLEL_SUFFIXES = ("to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj",
                          "linear_1", "proj", "mlp_fc1")
_ROW_PARALLEL_SUFFIXES = ("to_out_0", "out_proj", "mlp_fc2", "net_2", "linear_2")


def require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the parallel package needs an initialised process group "
                           "(torch.distributed.init_process_group); it does not run the "
                           "single-device path in its place")


def axis_group(mesh=None, axis: Optional[str] = None):
    """(process group, its size, this rank's index in it) of ``mesh``'s
    ``axis``, or of the whole group when ``mesh`` is None. Raises without an
    initialised process group."""
    require_group()
    if mesh is None:
        return dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.size(dim), mesh.get_local_rank(axis)


def make_mesh(data: Optional[int] = None, model: int = 1,
              axis_names: Tuple[str, str] = AXIS_NAMES, device_type: str = "cuda"):
    """A (data × model) ``DeviceMesh`` over every rank of the group, named
    ``axis_names``; ``device_type`` "cuda" (NCCL) or "cpu" (gloo). JAX's
    ``n_devices`` has no counterpart: a mesh spans the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    require_group()
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=tuple(axis_names))


def flax_axis_to_torch(axis: int, ndim: int) -> int:
    """The torch dim of a flax kernel's ``axis``: a Dense kernel (in, out)
    is (out, in) in torch, a conv kernel (k..., in, out) is (out, in, k...)."""
    axis %= ndim
    if axis == ndim - 1:
        return 0
    if axis == ndim - 2:
        return 1
    return axis + 2


def _parent(key: str) -> str:
    """The flax module name that owns a torch parameter key: the last module
    name, joined to a numeric index as flax names a list entry
    (``to_out.0.weight`` → ``to_out_0``)."""
    parts = key.split(".")[:-1]
    if len(parts) >= 2 and parts[-1].isdigit():
        return f"{parts[-2]}_{parts[-1]}"
    return parts[-1] if parts else ""


def param_partition_spec(key: str, value, model_axis: str = "model") -> tuple:
    """Sharding rule for one parameter by its torch key: a tuple with one
    entry per dim (the mesh axis that dim shards over, or None), or ``()``
    to replicate. Linear and conv weights of attention and MLP layers shard
    over the model axis (conv weights over their output channels); biases,
    norms, embeddings and everything else replicate (JAX ``mesh.py:88-108``
    with its axes moved to torch's layout)."""
    shape = tuple(value.shape)
    if not shape or not key.endswith(".weight") or len(shape) < 2:
        return ()
    parent = _parent(key)
    if parent.endswith("embedding"):
        return ()  # an nn.Embedding table: flax's "embedding", never a kernel
    dim = None
    if any(parent == s or parent.startswith(s) for s in _COL_PARALLEL_SUFFIXES):
        dim = flax_axis_to_torch(-1, len(shape))
    elif any(parent == s or parent.startswith(s) for s in _ROW_PARALLEL_SUFFIXES):
        dim = flax_axis_to_torch(0, len(shape))
    elif len(shape) >= 4:  # conv weights: output channels
        dim = flax_axis_to_torch(-1, len(shape))
    if dim is None:
        return ()
    return tuple(model_axis if d == dim else None for d in range(len(shape)))


def shard_params(params, mesh, model_axis: str = "model"):
    """A module's state dict (or a state dict) as ``DTensor``s on ``mesh``:
    ``Shard(d)`` on the model axis where :func:`param_partition_spec` shards
    dim d and the size of d divides by that axis, ``Replicate()`` otherwise
    and on every other axis."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    require_group()
    state = params.state_dict() if isinstance(params, torch.nn.Module) else params
    size = mesh.size(mesh.mesh_dim_names.index(model_axis))
    out = {}
    for key, value in state.items():
        spec = param_partition_spec(key, value, model_axis)
        dims = [d for d, name in enumerate(spec) if name is not None]
        placements = []
        for name in mesh.mesh_dim_names:
            if name == model_axis and dims and value.shape[dims[0]] % size == 0:
                placements.append(Shard(dims[0]))
            else:
                placements.append(Replicate())
        out[key] = distribute_tensor(value, mesh, placements)
    return out


# ------------------------------------------------------------- collectives

def _global(group, rank: int) -> int:
    return rank if group is None or group is dist.group.WORLD else dist.get_global_rank(group,
                                                                                      rank)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group, rank: int
             ) -> torch.Tensor:
    """JAX's ``lax.ppermute``: rank ``src`` sends ``x`` to ``dst`` for each
    pair; returns what this rank receives (zeros when it receives nothing).
    Every rank of ``group`` calls it with the same ``perm``; no rank sends to
    itself."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x, _global(group, dst), group) for src, dst in perm
           if src == rank]
    ops += [dist.P2POp(dist.irecv, out, _global(group, src), group) for src, dst in perm
            if dst == rank]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def send(x: torch.Tensor, dst: int, group) -> None:
    dist.send(x.contiguous(), _global(group, dst), group=group)


def recv_like(x: torch.Tensor, src: int, group) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.recv(out, _global(group, src), group=group)
    return out


def all_gather(x: torch.Tensor, size: int, group) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` (at least 1-D) in rank order, on
    every rank (``all_gather_into_tensor``; ``all_gather_single`` where
    torch has renamed it)."""
    x = x.contiguous()
    out = x.new_empty((size,) + tuple(x.shape))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out.view((size * x.shape[0],) + tuple(x.shape[1:])), x, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``lax.psum``: the sum over the group, on every rank."""
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x

