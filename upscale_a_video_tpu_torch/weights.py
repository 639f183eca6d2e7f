"""Parameter trees of the JAX reference → the port's state dicts.

Counterpart of ``upscale_a_video_tpu/utils/convert.py:50-112``, run in the
other direction. A flax parameter tree, flattened to ``{path tuple: array}``,
becomes a state dict whose keys are the reference's own torch key names
(``down_blocks.1.attentions.0...``), so the port's modules, which carry those
names, take it with ``load_state_dict(strict=True)`` and the released torch
``.bin`` bundle needs no conversion step.

Rules (flax path → torch key): ``name_3`` → ``name.3`` unless the digit is part
of the name (``conv1``, ``linear_1`` ...); ``base``/``params`` segments and the
inner ``conv`` wrapper segment are dropped; ``kernel``/``scale``/``embedding``
→ ``weight``, with kernels transposed HWIO→OIHW, DHWIO→OIDHW, (I,O)→(O,I).
:func:`raft_state_dict` gives a RAFT tree ``raft-things.pth``'s key names
(the inverse of ``upscale_a_video_tpu/models/raft.py:470``),
:func:`llava_state_dict` a LLaVA tree the released checkpoints' keys,
:func:`discriminator_state_dict` the VAE finetune's PatchGAN and
:func:`propagator_state_dict` the learnable propagator (the reference's
module names; a deformable conv's 4-D ``weight``/``dcn_weight`` param is
transposed HWIO→OIHW like a kernel).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

_INDEX_RE = re.compile(r"^(.*)_(\d+)$")
_NO_INDEX_SPLIT = {
    "linear_1", "linear_2", "norm1", "norm2", "norm3", "conv1", "conv2",
    "mlp_fc1", "mlp_fc2", "norm_3d", "conv_3d",
}
_DROP_SEGMENTS = {"base", "params"}

CLIP_RENAMES = {
    "mlp_fc1": "mlp.fc1",
    "mlp_fc2": "mlp.fc2",
    "layers.": "encoder.layers.",
    "token_embedding": "embeddings.token_embedding",
    "position_embedding.weight": "embeddings.position_embedding.weight",
}

# the inverse of the JAX package's RAFT_RENAMES: FrozenBatchNorm's four
# parameters are the torch BatchNorm's weight, bias and running statistics
RAFT_RENAMES = {
    ".bn.mean": ".running_mean", ".bn.var": ".running_var",
    ".bn.weight": ".weight", ".bn.bias": ".bias", ".gn.": ".",
    "conv_.weight": "conv.weight", "conv_.bias": "conv.bias",
}


def _segment(seg: str) -> str:
    if seg in _NO_INDEX_SPLIT:
        return seg
    m = _INDEX_RE.match(seg)
    return f"{m.group(1)}.{m.group(2)}" if m else seg


def torch_key(path: Tuple[str, ...], renames: Optional[Mapping[str, str]] = None) -> str:
    """The reference's torch state-dict key for one flax parameter path."""
    *body, leaf = path
    if body and body[-1] == "conv":
        body = body[:-1]
    segs = [_segment(s) for s in body if s not in _DROP_SEGMENTS]
    if leaf in ("kernel", "scale", "embedding"):
        leaf = "weight"
    elif leaf == "relative_attention_bias":
        segs.append("time_rel_pos_bias.relative_attention_bias")
        leaf = "weight"
    elif leaf == "position_embedding":
        segs.append("position_embedding")
        leaf = "weight"
    key = ".".join(segs + [leaf])
    for old, new in (renames or {}).items():
        key = key.replace(old, new)
    return key


def _perm(path: Tuple[str, ...], ndim: int):
    if path[-1] in ("weight", "dcn_weight") and ndim == 4:
        return 3, 2, 0, 1  # a deformable conv's HWIO weight (a flax param, not a kernel)
    if path[-1] != "kernel":
        return None
    return {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}.get(ndim)


def torch_shape(path: Tuple[str, ...], shape: Iterable[int]) -> Tuple[int, ...]:
    shape = tuple(shape)
    perm = _perm(path, len(shape))
    return shape if perm is None else tuple(shape[i] for i in perm)


def flatten_tree(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    """Nested dict (a flax ``params`` tree) → ``{path tuple: leaf}``."""
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def to_state_dict(flat: Mapping[Tuple[str, ...], np.ndarray],
                  renames: Optional[Mapping[str, str]] = None,
                  dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """``{flax path: array}`` → the port's state dict (reference key names),
    in ``dtype`` (a float64 ``dtype`` keeps float64 arrays exact)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        v = np.array(value, dtype=np.float64 if dtype == torch.float64 else np.float32)
        perm = _perm(path, v.ndim)
        if perm is not None:
            v = v.transpose(perm)
        key = torch_key(path, renames)
        if key in out:
            raise KeyError(f"two parameters map to {key!r}")
        out[key] = torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
    return out


def raft_state_dict(flat: Mapping[Tuple[str, ...], np.ndarray]) -> Dict[str, torch.Tensor]:
    """A JAX RAFT parameter tree (``{path: array}``) → a state dict with
    ``raft-things.pth``'s keys: each BatchNorm gains ``num_batches_tracked``,
    and a block's downsampling norm (``norm3`` of a ResidualBlock, ``norm4``
    of a BottleneckBlock) appears a second time as ``downsample.1``, where
    the reference registers the same module."""
    sd = to_state_dict(flat, RAFT_RENAMES)
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    for key in list(sd):
        m = re.fullmatch(r"(.*)\.norm([34])\.(\w+)", key)
        if m is None or f"{m[1]}.downsample.0.weight" not in sd:
            continue
        last = "4" if any(k.startswith(f"{m[1]}.norm4.") for k in sd) else "3"
        if m[2] == last:
            sd[f"{m[1]}.downsample.1.{m[3]}"] = sd[key]
    return sd


def llava_state_dict(flat: Mapping[Tuple[str, ...], np.ndarray],
                     mpt: bool = False) -> Dict[str, torch.Tensor]:
    """A JAX LLaVA parameter tree (``{path: array}``, LLaMA or, with ``mpt``,
    MPT decoder) → the HF checkpoint keys the port's LLaVA modules carry,
    through the copied rename tables (``models/llava/convert.py``)."""
    from .models.llava.convert import LLAVA_MPT_RENAMES, LLAVA_RENAMES

    return to_state_dict(flat, LLAVA_MPT_RENAMES if mpt else LLAVA_RENAMES)


# the learnable propagator (``models/propagation_learnable.py``): its
# per-direction modules and the residual stacks' ``main`` as the reference's
# ModuleDicts and Sequentials
PROPAGATOR_RENAMES = {
    "deform_align_backward_prop.": "deform_align.backward_prop.",
    "deform_align_forward_prop.": "deform_align.forward_prop.",
    "backbone_backward_prop.": "backbone.backward_prop.",
    "backbone_forward_prop.": "backbone.forward_prop.",
    ".main_2.": ".main.2.",
}


def propagator_state_dict(flat: Mapping[Tuple[str, ...], np.ndarray],
                          dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """A JAX ``LearnablePropagation`` tree → the port's (reference key
    names; the deformable convs' HWIO ``weight`` → OIHW)."""
    return to_state_dict(flat, PROPAGATOR_RENAMES, dtype)


def discriminator_state_dict(flat: Mapping[Tuple[str, ...], np.ndarray]) -> Dict[str, torch.Tensor]:
    """A JAX ``PatchDiscriminator`` tree (``training/train_vae.py``) → the
    port's: ``conv_in``/``conv_i``/``conv_out`` kernels HWIO → OIHW,
    ``norm_i`` GroupNorm scale and bias → ``norm.i.weight``/``.bias``."""
    return to_state_dict(flat)


@torch.no_grad()
def init_random_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """PyTorch's default initialisers, drawn from ``generator`` on the
    parameters' own device: Linear/Conv weight and bias U(±1/√fan_in),
    Embedding N(0, 1), norms ones and zeros, any other parameter (a class
    token) N(0, 0.02), after the rest. Works on a module made with
    ``to_empty``, so full-size weights never pass through the host."""
    done = set()
    for m in module.modules():
        w = getattr(m, "weight", None)
        b = getattr(m, "bias", None)
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.Conv3d)):
            bound = 1.0 / float(np.sqrt(w[0].numel()))
            w.uniform_(-bound, bound, generator=generator)
            if b is not None:
                b.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, torch.nn.Embedding):
            w.normal_(0.0, 1.0, generator=generator)
        elif isinstance(w, torch.nn.Parameter) and w.ndim == 1:
            w.fill_(1.0)
            if b is not None:
                b.zero_()
        else:
            continue
        done.update(id(t) for t in (w, b) if t is not None)
    for p in module.parameters():
        if id(p) not in done:
            p.normal_(0.0, 0.02, generator=generator)
    return module
