"""CLIP byte-level BPE text tokenization for the text tower.

A framework-free copy of ``image_retrieval_tpu/models/tokenizer.py`` (that
package's ``models/__init__`` imports jax, so the port cannot import it);
tests/test_torch_clip.py pins the token ids of the two copies together.

The reference tokenizes queries with HF ``CLIPProcessor`` (byte-level BPE;
reference ``image_search.py:47-64``, ``app_pipeline.py:184-186``). This module
implements that algorithm natively:

- GPT-2 style byte→unicode mapping so arbitrary UTF-8 is representable,
- the CLIP word-splitting regex (contractions, letter runs, single digits,
  punctuation runs),
- greedy lowest-rank BPE merges with an end-of-word ``</w>`` marker,
- ``<|startoftext|>`` / ``<|endoftext|>`` special-token layout with a
  77-position context and zero padding (OpenAI's original layout; the text
  tower pools at argmax(token_id), which tolerates either pad convention).

Vocab/merges load from a checkpoint directory (``Config.weights_path``) when
one is vendored; otherwise a small deterministic fixture vocab (trained by
``tools/make_bpe_fixture.py``; the port keeps its own copy under
``models/bpe_fixture/``, which tests/test_torch_config.py pins byte for byte
to the JAX package's) keeps the production path on real BPE. The hash tokenizer is a test-only fallback
and is never returned by :func:`get_tokenizer`.

Text normalization matches HF's no-ftfy path (``transformers``
``CLIPTokenizer`` with its ``BasicTokenizer(strip_accents=False,
do_split_on_punc=False)``): control-char removal, CJK spacing, NFC
normalization, whitespace collapse, lowercasing. Parity is tested against
``transformers.CLIPTokenizer`` in tests/test_tokenizer.py.
"""

from __future__ import annotations

import functools
import hashlib
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

# The port's copy of the fixture vocab (tests/test_torch_config.py holds it
# byte for byte to the JAX package's, so token ids cannot drift apart).
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

    Replaces the reference's HF CLIPProcessor text path
    (``image_search.py:47-64``). Load from any HF-format CLIP checkpoint
    directory containing ``vocab.json`` + ``merges.txt``.
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


_WORD_RE = _re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class HashTokenizer:
    """Deterministic word-hash tokenizer — TEST-ONLY fallback.

    Kept for fixtures that need tokens without any vocab file; the
    production path (:func:`get_tokenizer`) always returns real BPE.
    """

    context_length = CONTEXT
    bos_id = BOS
    eos_id = EOS
    pad_id = PAD
    vocab_size = VOCAB

    def __call__(self, texts: List[str], context_length: int = CONTEXT) -> np.ndarray:
        out = np.full((len(texts), context_length), PAD, np.int32)
        for i, text in enumerate(texts):
            words = _WORD_RE.findall(text.lower().strip())
            ids = [BOS]
            for w in words[: context_length - 2]:
                h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
                ids.append(1 + h % (BOS - 1))  # in [1, 49405]
            ids.append(EOS)
            out[i, : len(ids)] = ids[:context_length]
        return out


def get_tokenizer(weights_path: Optional[str] = None) -> CLIPBPETokenizer:
    """Production tokenizer: real BPE from the checkpoint dir when present,
    else the vendored fixture vocab. Never the hash fallback."""
    if weights_path:
        vocab = os.path.join(weights_path, "vocab.json")
        merges = os.path.join(weights_path, "merges.txt")
        if os.path.exists(vocab) and os.path.exists(merges):
            return CLIPBPETokenizer(vocab, merges)
    return CLIPBPETokenizer(
        os.path.join(FIXTURE_DIR, "vocab.json"),
        os.path.join(FIXTURE_DIR, "merges.txt"),
    )
