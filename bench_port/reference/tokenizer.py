"""CLIP byte-level BPE tokenization, the reference's own copy.

A frozen copy of the program's `models/tokenizer.py` (its BPE algorithm,
text normalization and special-token layout) with its fixture vocabulary
beside it in `bpe_fixture/`, so that the reference works out the tokens of
a query again without importing anything of the program. The program's
tokenizer reads the same fixture when no checkpoint is configured, which is
how the benchmark runs it.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

try:  # \p{L}/\p{N} classes need the third-party regex module
    import regex as _re

    _HAVE_REGEX = True
except ImportError:  # pragma: no cover - regex ships with transformers
    import re as _re

    _HAVE_REGEX = False

# Special-token layout of the real openai/clip-vit-base-patch32 vocab. The
# fixture vocab is smaller; its ids come from the vocab file itself.
BOS = 49406
EOS = 49407
PAD = 0
CONTEXT = 77
VOCAB = 49408

# A copy of the program's fixture vocabulary, byte for byte.
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_fixture")

if _HAVE_REGEX:
    _CLIP_SPLIT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
else:  # ASCII-only approximation (regex module absent)
    _CLIP_SPLIT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    )


@functools.lru_cache(maxsize=1)
def byte_to_unicode() -> Dict[int, str]:
    """GPT-2 reversible byte→printable-unicode map.

    Printable latin bytes map to themselves; the rest are relocated to
    256+k so no BPE symbol is whitespace or a control character.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    mapping = {b: chr(b) for b in keep}
    bump = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + bump)
            bump += 1
    return mapping


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_space(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def normalize_text(text: str) -> str:
    """HF CLIPTokenizer's no-ftfy normalization: strip control chars, space
    out CJK ideographs, NFC-normalize, collapse whitespace, lowercase."""
    cleaned: List[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_space(ch):
            cleaned.append(" ")
        elif any(lo <= cp <= hi for lo, hi in _CJK_RANGES):
            cleaned.append(f" {ch} ")
        else:
            cleaned.append(ch)
    text = unicodedata.normalize("NFC", "".join(cleaned))
    return " ".join(w.lower() for w in text.split())


class CLIPBPETokenizer:
    """Byte-level BPE tokenizer with CLIP's merge semantics.

    Loads any HF-format ``vocab.json`` + ``merges.txt``.
    """

    context_length = CONTEXT

    def __init__(self, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        if lines and lines[0].startswith("#"):
            lines = lines[1:]
        self.ranks: Dict[Tuple[str, str], int] = {}
        for rank, line in enumerate(lines):
            parts = tuple(line.split())
            if len(parts) == 2:
                self.ranks[parts] = rank  # type: ignore[index]
        self._byte_enc = byte_to_unicode()
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        self.unk_id = self.eos_id
        self.pad_id = PAD
        self.vocab_size = len(self.encoder)
        # literal special tokens in the text pass through unsplit
        self._seed_cache: Dict[str, List[str]] = {
            "<|startoftext|>": ["<|startoftext|>"],
            "<|endoftext|>": ["<|endoftext|>"],
        }
        self._cache: Dict[str, List[str]] = dict(self._seed_cache)

    # -- BPE core ---------------------------------------------------------

    def _merge_word(self, symbols: List[str]) -> List[str]:
        """Greedy lowest-rank merging until no known pair remains."""
        while len(symbols) > 1:
            best_rank = None
            best_at = -1
            for i in range(len(symbols) - 1):
                r = self.ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_at = r, i
            if best_rank is None:
                break
            pair = (symbols[best_at], symbols[best_at + 1])
            # fuse every occurrence of the winning pair, left to right
            out: List[str] = []
            i = 0
            while i < len(symbols):
                if (
                    i + 1 < len(symbols)
                    and symbols[i] == pair[0]
                    and symbols[i + 1] == pair[1]
                ):
                    out.append(pair[0] + pair[1])
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out
        return symbols

    # Cap the per-word BPE cache: the tokenizer lives in a persistent
    # serving process and arbitrary user queries would otherwise grow it
    # without bound. 64k distinct words is far beyond any realistic hot
    # set; on overflow, drop back to the seed entries and rebuild.
    _CACHE_CAP = 65536

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        symbols = list(token[:-1]) + [token[-1] + "</w>"]
        pieces = self._merge_word(symbols)
        if len(self._cache) >= self._CACHE_CAP:
            self._cache = dict(self._seed_cache)
        self._cache[token] = pieces
        return pieces

    # -- public API -------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids, without special tokens."""
        ids: List[int] = []
        for tok in _CLIP_SPLIT.findall(normalize_text(text)):
            mapped = "".join(self._byte_enc[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder.get(piece, self.unk_id))
        return ids

    def __call__(self, texts: List[str], context_length: int = CONTEXT) -> np.ndarray:
        out = np.full((len(texts), context_length), self.pad_id, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos_id] + self.encode(text)[: context_length - 2] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


def fixture_tokenizer() -> CLIPBPETokenizer:
    """The tokenizer over the fixture vocabulary, the one the program reads
    when no checkpoint directory is configured."""
    return CLIPBPETokenizer(
        os.path.join(FIXTURE_DIR, "vocab.json"),
        os.path.join(FIXTURE_DIR, "merges.txt"),
    )
