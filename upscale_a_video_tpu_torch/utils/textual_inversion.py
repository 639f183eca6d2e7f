"""Textual-inversion loading (port of ``upscale_a_video_tpu/utils/textual_inversion.py``;
ref: ``VideoUpscalePipeline`` inherits diffusers' ``TextualInversionLoaderMixin``,
pipeline_upscale_a_video.py:61).

A textual-inversion checkpoint maps one or more placeholder tokens (e.g.
``<concept>``) to learned embedding vectors in the text encoder's input
space. Loading it (a) registers each placeholder with the tokenizer, under
a new id past the vocabulary, and (b) grows the CLIP token-embedding table
by the learned rows. Both schemas diffusers reads are accepted:

- diffusers: ``{token: tensor(dim) | tensor(n, dim)}``
- A1111/SD: ``{"string_to_param": {"*": tensor(n, dim)}, "name": token}``

A concept of n vectors expands to ``token token_1 .. token_{n-1}`` in a
prompt, as diffusers does. The JAX package maps placeholders to ids through
the HF ``CLIPTokenizer``'s added tokens; the port's tokenizer is its own
BPE (``utils/clip_bpe.py``), so :class:`TextualInversionTokenizer` does what
added tokens do there: it splits a prompt at the placeholders, encodes the
text between them and puts each placeholder's id in its place.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..ops import _cuda


def parse_textual_inversion(state: Dict[str, Any], token: str = None):
    """Checkpoint dict → list of (token_string, (n_vectors, dim) ndarray)."""
    def to_np(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().float().numpy()
        else:
            t = np.asarray(t, np.float32)
        return t.reshape(1, -1) if t.ndim == 1 else t

    if "string_to_param" in state:  # A1111 schema
        emb = to_np(next(iter(state["string_to_param"].values())))
        name = token or state.get("name", "<concept>")
        return [(name, emb)]
    entries = []
    for k, v in state.items():
        if k in ("name", "step", "sd_checkpoint", "sd_checkpoint_name"):
            continue
        entries.append((token or k, to_np(v)))
    if not entries:
        raise ValueError("no embeddings found in textual-inversion checkpoint")
    return entries


def _expand_multi(entries) -> List[Tuple[str, str, np.ndarray]]:
    """(tok, (n, d)) → n single-vector (part_token, base_token, vec) rows:
    tok, tok_1, ... (diffusers TextualInversionLoaderMixin
    .maybe_convert_prompt convention)."""
    flat = []
    for tok, emb in entries:
        for i in range(emb.shape[0]):
            flat.append((tok if i == 0 else f"{tok}_{i}", tok, emb[i]))
    return flat


class TextualInversionTokenizer:
    """Wraps a ``prompts -> (B, L) ids`` tokenizer with placeholder tokens.
    Prompts without a placeholder go to the base tokenizer as they are;
    with one, the base must have ``encode(text) -> ids`` and the
    ``sot_id``/``eot_id``/``context_length`` of ``clip_bpe.CLIPBPETokenizer``:
    the text between placeholders is encoded, each placeholder becomes its
    id, and the ids are framed and padded as the base frames them."""

    def __init__(self, base, vocab_size: int):
        self.base = base
        self.vocab_size = vocab_size
        self.tokens: Dict[str, int] = {}
        # base placeholder -> ordered part tokens (the base itself first),
        # kept so that placeholders containing '_' expand correctly
        self.groups: Dict[str, List[str]] = {}

    def add_token(self, token: str, group: str = None) -> int:
        """Register ``token``; ``group`` names the base placeholder this
        token is a multi-vector part of (defaults to itself)."""
        if token not in self.tokens:
            self.tokens[token] = self.vocab_size + len(self.tokens)
        base = group if group is not None else token
        parts = self.groups.setdefault(base, [])
        if token not in parts:
            parts.append(token)
        return self.tokens[token]

    def expand_prompt(self, prompt: str) -> str:
        """Multi-vector expansion: '<c>' -> '<c> <c>_1 ...' when present."""
        for base in sorted(self.groups, key=len, reverse=True):
            if base in prompt:
                prompt = prompt.replace(base, " ".join(self.groups[base]))
        return prompt

    def encode(self, text: str) -> List[int]:
        """Ids of ``text`` without framing: placeholders (longest first, as
        added tokens match) by their ids, the rest by the base's BPE."""
        pattern = "|".join(re.escape(t) for t in sorted(self.tokens, key=len, reverse=True))
        ids: List[int] = []
        pos = 0
        for m in re.finditer(pattern, text):
            ids += self.base.encode(text[pos:m.start()])
            ids.append(self.tokens[m.group()])
            pos = m.end()
        return ids + self.base.encode(text[pos:])

    def __call__(self, prompts):
        prompts = [self.expand_prompt(p) for p in prompts]
        if not any(t in p for p in prompts for t in self.tokens):
            return self.base(prompts)
        if not hasattr(self.base, "encode"):
            raise ValueError("textual-inversion placeholders require the CLIP BPE tokenizer "
                             "(utils/clip_bpe.py); this tokenizer cannot map them to ids")
        n = self.base.context_length
        out = np.full((len(prompts), n), self.base.eot_id, dtype=np.int32)
        out[:, 0] = self.base.sot_id
        for i, p in enumerate(prompts):
            ids = self.encode(p)[: n - 2]
            out[i, 1:1 + len(ids)] = ids
        return out


def load_textual_inversion(pipeline, state: Dict[str, Any], token: str = None):
    """Load a textual-inversion checkpoint into a pipeline in place: extend
    the tokenizer and grow the CLIP token embedding by the learned rows.
    Returns the list of registered token strings. The pipeline's captured
    denoise loop and the text encoder's cached kernel operands are dropped:
    they were made with the old table."""
    entries = _expand_multi(parse_textual_inversion(state, token))

    encoder = pipeline.m.text_encoder
    table = encoder.embeddings.token_embedding
    vocab, dim = table.weight.shape
    if entries[0][2].shape[-1] != dim:
        raise ValueError(f"embedding dim {entries[0][2].shape[-1]} != text encoder {dim}")

    if not isinstance(pipeline.m.tokenizer, TextualInversionTokenizer):
        pipeline.m.tokenizer = TextualInversionTokenizer(pipeline.m.tokenizer, vocab)
    tok = pipeline.m.tokenizer
    rows = [(tok.add_token(name, group=base), vec) for name, base, vec in entries]

    new_vocab = max(vocab, max(tid for tid, _ in rows) + 1)
    with torch.no_grad():
        weight = torch.cat([table.weight, table.weight.new_zeros(new_vocab - vocab, dim)])
        for tid, vec in rows:
            weight[tid] = torch.as_tensor(vec, dtype=weight.dtype)
    table.weight = torch.nn.Parameter(weight, requires_grad=table.weight.requires_grad)
    table.num_embeddings = new_vocab
    encoder.config = dataclasses.replace(encoder.config, vocab_size=new_vocab)
    _cuda.drop_cached(encoder)
    pipeline.graphs.clear()
    # the position embeddings are untouched: the new ids enter only through
    # the token lookup (CLIPTextModel.forward)
    return [name for name, _, _ in entries]
