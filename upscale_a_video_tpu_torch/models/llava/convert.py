"""The key tables of the LLaVA checkpoints (own copies of
``upscale_a_video_tpu/models/llava/convert.py:22-84``) and the delta merge.

The port's modules carry the HF ``llava-v1.5`` key names themselves
(``model.vision_tower.vision_tower.vision_model.*``,
``model.mm_projector.{0,2}``, ``model.embed_tokens``, ``model.layers.N.*``,
``model.norm``, ``lm_head``; MPT's ``transformer.*``), so a released
checkpoint needs no converter. The tables map the JAX package's flax names
onto those keys: ``weights.llava_state_dict`` applies them, in order, as
``str.replace`` after the generic flax-path rule, to carry JAX parameters
into the port.
"""

from __future__ import annotations

from typing import Dict

import torch

LLAVA_RENAMES: Dict[str, str] = {
    "vision_tower.": "model.vision_tower.vision_tower.vision_model.",
    "vision_model.layers.": "vision_model.encoder.layers.",
    "vision_model.patch_embedding.weight": "vision_model.embeddings.patch_embedding.weight",
    "vision_model.class_embedding": "vision_model.embeddings.class_embedding",
    "vision_model.position_embedding.weight": "vision_model.embeddings.position_embedding.weight",
    "mlp_fc1": "mlp.fc1",
    "mlp_fc2": "mlp.fc2",
    "mm_projector.0": "model.mm_projector.0",
    "mm_projector.2": "model.mm_projector.2",
    "language_model.embed_tokens.weight": "model.embed_tokens.weight",
    "language_model.model.": "model.",
    "language_model.lm_head": "lm_head",
    "self_attn_q_proj": "self_attn.q_proj",
    "self_attn_k_proj": "self_attn.k_proj",
    "self_attn_v_proj": "self_attn.v_proj",
    "self_attn_o_proj": "self_attn.o_proj",
    "self_attn_out_proj": "self_attn.out_proj",
    "mlp_gate_proj": "mlp.gate_proj",
    "mlp_up_proj": "mlp.up_proj",
    "mlp_down_proj": "mlp.down_proj",
}

# MPT (HF mosaicml keys); the flax ``norm_1`` comes out of the generic index
# rule as ``norm.1``, which is undone here
MPT_RENAMES: Dict[str, str] = {
    "attn_Wqkv": "attn.Wqkv",
    "attn_out_proj": "attn.out_proj",
    "attn_q_ln": "attn.q_ln",
    "attn_k_ln": "attn.k_ln",
    "ffn_up_proj": "ffn.up_proj",
    "ffn_down_proj": "ffn.down_proj",
    "norm.1": "norm_1",
    "norm.2": "norm_2",
    "blocks.": "transformer.blocks.",
    "wte.weight": "transformer.wte.weight",
    "wpe.weight": "transformer.wpe.weight",
    "norm_f.": "transformer.norm_f.",
}

# LLaVA-MPT: the vision tower and the projector hang off ``transformer``.
# The JAX table leaves out the vision tower's ``self_attn_*`` entries, so it
# maps those projections to keys no checkpoint has (ROADMAP C3); this copy
# keeps them (MPT's own keys never contain ``self_attn_``).
LLAVA_MPT_RENAMES: Dict[str, str] = dict(
    {"language_model.": ""},
    **{k: v for k, v in LLAVA_RENAMES.items() if "vision" in k
       or "mm_projector" in k or k.startswith(("mlp_fc", "self_attn_"))
       or "class_embedding" in k or "position_embedding" in k},
    **MPT_RENAMES,
    **{"model.vision_tower": "transformer.vision_tower",
       "model.mm_projector": "transformer.mm_projector"},
)


def apply_delta(base: Dict[str, torch.Tensor],
                delta: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """base + delta (ref llava/model/apply_delta.py): elementwise; rows past
    the base vocabulary (``embed_tokens``, ``lm_head``) come from the delta."""
    out = {}
    for k, dv in delta.items():
        bv = base.get(k)
        if bv is None:
            out[k] = dv
        elif bv.shape == dv.shape:
            out[k] = bv + dv
        else:
            merged = dv.clone()
            merged[: bv.shape[0]] += bv
            out[k] = merged
    return out
