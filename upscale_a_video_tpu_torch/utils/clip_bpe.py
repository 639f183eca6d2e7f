"""In-repo CLIP byte-level BPE tokenizer.

A copy of ``upscale_a_video_tpu/utils/clip_bpe.py`` (numpy, the standard
library and ``regex``, the last imported only when a tokenizer is built), kept
here so the port imports nothing of the JAX package.

The reference loads HF's ``CLIPTokenizer`` from the released weight bundle's
``tokenizer/`` folder (pipeline_upscale_a_video.py:65, README.md:87-101) and
pads prompts to 77 ids (``_encode_prompt``, :231-240). This module implements
the same tokenizer from first principles so prompt conditioning is
self-contained — no ``transformers`` dependency on the text path and no silent
byte-hash fallback.

Two on-disk schemas load:

- HF/diffusers bundle: ``vocab.json`` (token → id) + ``merges.txt``
  (one merge pair per line, optional ``#version`` header) — the layout of the
  released ``tokenizer/`` folder.
- OpenAI original: ``bpe_simple_vocab_16e6.txt.gz`` (CLIP repo
  ``simple_tokenizer.py`` format); the vocab is reconstructed exactly as
  upstream does (256 bytes, 256 ``</w>`` bytes, 48 894 merge outputs, 2
  specials = 49 408 entries).

Algorithm notes (must match HF ``CLIPTokenizer`` token-for-token):

- GPT-2 ``bytes_to_unicode`` byte mapping.
- Pre-tokenization regex: contractions, letter runs, single digits, symbol
  runs (the ``regex`` module supplies ``\\p{L}``/``\\p{N}``), case-insensitive.
- Cleaning follows the path the reference ACTUALLY runs: its requirements.txt
  pins no ftfy, so HF ``CLIPTokenizer`` falls back to a BERT-style
  ``BasicTokenizer(strip_accents=False, do_split_on_punc=False)`` —
  control-char removal, spaces inserted around CJK chars (each CJK char
  becomes its own ``</w>``-terminated word), lowercase, whitespace
  normalization (transformers tokenization_clip.py ``_tokenize`` no-ftfy
  branch). The OpenAI-canonical ftfy path differs only on mojibake and on
  CJK grouping.
- Per word: last symbol gets ``</w>``; merge the lowest-rank pair until none
  remains.
"""

from __future__ import annotations

import functools
import gzip
import json
import os
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
CONTEXT_LENGTH = 77  # ref _encode_prompt max_length padding


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → printable-unicode map (the standard table:
    printable ASCII/latin ranges map to themselves, the rest shift to 256+)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


def _is_cjk(cp: int) -> bool:
    """CJK Unicode blocks (BasicTokenizer._is_chinese_char)."""
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def basic_clean(text: str) -> str:
    """The no-ftfy HF path: ``" ".join(BasicTokenizer(strip_accents=False,
    do_split_on_punc=False).tokenize(text))`` — control chars dropped,
    whitespace collapsed, CJK chars isolated, lowercased."""
    chars = []
    for ch in text:
        cp = ord(ch)
        if cp in (0, 0xFFFD):
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C") and ch not in ("\t", "\n", "\r"):
            continue  # control chars
        if _is_cjk(cp):
            chars += [" ", ch, " "]
        elif cat == "Zs" or ch in ("\t", "\n", "\r"):
            chars.append(" ")
        else:
            chars.append(ch)
    return " ".join("".join(chars).lower().split())


class CLIPBPETokenizer:
    """Callable ``prompts -> int32 (B, 77)`` ids, matching the reference's
    pad-to-max-length truncating encoding (pipeline_upscale_a_video.py:231-240,
    pad token = ``<|endoftext|>`` as in the SD ×4-upscaler bundle)."""

    def __init__(self, encoder: Dict[str, int],
                 bpe_ranks: Dict[Tuple[str, str], int],
                 context_length: int = CONTEXT_LENGTH):
        import regex  # \p{L}/\p{N} classes; stdlib `re` lacks them

        self.encoder = dict(encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(bpe_ranks)
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._cache = {SOT: SOT, EOT: EOT}
        self._pat = regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE,
        )

    # ------------------------------------------------------------ loading

    @classmethod
    def from_hf_dir(cls, path: str, context_length: int = CONTEXT_LENGTH
                    ) -> "CLIPBPETokenizer":
        """Load from a diffusers-style ``tokenizer/`` folder
        (``vocab.json`` + ``merges.txt`` — the released bundle layout)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            encoder = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        ranks = {pair: i for i, pair in enumerate(merges)}
        return cls(encoder, ranks, context_length)

    @classmethod
    def from_openai_gz(cls, path: str, context_length: int = CONTEXT_LENGTH
                       ) -> "CLIPBPETokenizer":
        """Load OpenAI's ``bpe_simple_vocab_16e6.txt.gz`` and rebuild the
        vocab exactly as CLIP's ``simple_tokenizer.py`` does."""
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        encoder = {tok: i for i, tok in enumerate(vocab)}
        ranks = {pair: i for i, pair in enumerate(merges)}
        return cls(encoder, ranks, context_length)

    # ---------------------------------------------------------------- BPE

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids (no specials, no padding)."""
        text = basic_clean(text)
        ids: List[int] = []
        for token in self._pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) not in (self.sot_id, self.eot_id))
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # ------------------------------------------------------------- calling

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        n = self.context_length
        out = np.full((len(prompts), n), self.eot_id, dtype=np.int32)
        out[:, 0] = self.sot_id
        for i, p in enumerate(prompts):
            ids = self.encode(p)[: n - 2]  # truncation (ref :233)
            out[i, 1:1 + len(ids)] = ids
            # pad region stays eot (SD bundle pad_token == <|endoftext|>)
        return out


def load_clip_tokenizer(tokenizer_dir: str,
                        context_length: int = CONTEXT_LENGTH
                        ) -> CLIPBPETokenizer:
    """Load from a bundle ``tokenizer/`` dir: HF ``vocab.json``+``merges.txt``
    preferred, OpenAI ``bpe_simple_vocab_16e6.txt.gz`` accepted."""
    if os.path.isfile(os.path.join(tokenizer_dir, "vocab.json")):
        return CLIPBPETokenizer.from_hf_dir(tokenizer_dir, context_length)
    gz = os.path.join(tokenizer_dir, "bpe_simple_vocab_16e6.txt.gz")
    if os.path.isfile(gz):
        return CLIPBPETokenizer.from_openai_gz(gz, context_length)
    raise FileNotFoundError(
        f"no tokenizer assets in {tokenizer_dir} (need vocab.json+merges.txt "
        f"or bpe_simple_vocab_16e6.txt.gz)")
