"""Packed int4 gallery representation: quantize/pack, the two-dot sweep, the
tiled screen and the exact int8 rerank.

Port of ``image_retrieval_tpu/ops/int4.py``. The int4 tier halves gallery
bytes against int8: the device holds (N, D/2) uint8 nibble rows (lo nibble
= even dim, hi nibble = odd dim, +8 bias) and per-row norm-preserving
scales. Search is two-phase: an int4 cosine screen selects c candidates per
query, then an exact int8 rerank scores them (phase 2 has the resident int8
sweep's math, so its scores equal what ``dtype='int8'`` reports).

``quantize_pack_int4``, ``pack_nibbles`` and ``unpack_nibbles`` are host
numpy, copied verbatim (the JAX module imports jax). ``unpack2_dots``,
``screen_int4_topc`` and ``rerank_int8_topk`` are torch: the plain versions
of the screen, which the card runs through the hand-written kernel in
``ops/int4_screen.py``. ``unpack8_dots_i32`` is not ported: its int32-lane
decomposition only works around how XLA lowers 8-bit unpacking on a TPU.

Every product here is bf16 x small integer, exact in f32, so the plain
versions upcast their operands to f32 and sum in f32, as the JAX package's
``preferred_element_type=float32`` dots do (a torch bf16 matmul would round
its result to bf16).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from image_retrieval_tpu_torch.device import require_full_f32
from image_retrieval_tpu_torch.ops.topk import (
    exact_topk,
    resolve_ties,
    two_key_topk,
    wide_candidates,
)


def quantize_pack_int4(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize f32 rows to int4 and nibble-pack.

    Returns (packed (N, D/2) uint8, scales (N,) f32). Scales are
    norm-preserving: ||int4 row|| * scale == ||original row||, so for unit
    rows `raw_dot * scale` is the cosine approximation with no grid-norm
    bias (same property as the int8 path).
    """
    rows = np.asarray(rows, np.float32)
    assert rows.ndim == 2 and rows.shape[1] % 2 == 0, rows.shape
    absmax = np.maximum(np.abs(rows).max(axis=1), 1e-12)
    grid = (absmax / 7.0).astype(np.float32)
    q4 = np.clip(np.rint(rows / grid[:, None]), -7, 7).astype(np.int8)
    qn = np.linalg.norm(q4.astype(np.float32), axis=1)
    rn = np.linalg.norm(rows, axis=1)
    scales = (rn / np.where(qn > 0, qn, 1.0)).astype(np.float32)
    return pack_nibbles(q4), scales


def pack_nibbles(q4: np.ndarray) -> np.ndarray:
    """(N, D) int8 values in [-8, 7] -> (N, D/2) uint8 nibble-packed
    (lo = even dims, hi = odd dims, +8 bias)."""
    u = (np.asarray(q4, np.int16) + 8).astype(np.uint8)
    return u[:, 0::2] | (u[:, 1::2] << 4)


def unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """Inverse of pack_nibbles: (N, D/2) uint8 -> (N, D) int8 values."""
    packed = np.asarray(packed, np.uint8)
    lo = (packed & 0xF).astype(np.int8) - 8
    hi = (packed >> 4).astype(np.int8) - 8
    out = np.empty((packed.shape[0], packed.shape[1] * 2), np.int8)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return out


def unit_queries(queries: torch.Tensor) -> torch.Tensor:
    """(Q, D) -> f32 unit rows; a zero-norm query stays zero (the `qn > 0`
    guard of collectives.py:466-468)."""
    qf = queries.to(torch.float32)
    qn = torch.linalg.vector_norm(qf, dim=-1, keepdim=True)
    return torch.where(qn > 0, qf / torch.where(qn > 0, qn, 1.0), 0.0)


def unpack2_dots(queries_bf16: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """(Q, D) bf16 queries x (N, D/2) packed rows -> (Q, N) f32 raw dots.

    The two-dot decomposition: even-dim and odd-dim partial sums add. Both
    operands are exact in f32, so the f32 matmuls give the unrounded f32
    dots of the JAX version (on CUDA they must be full f32: TF32 refused).
    Multiply by the per-row scales for the cosine approximation."""
    require_full_f32(packed.device)
    q = queries_bf16.to(torch.bfloat16).to(torch.float32)
    lo = ((packed & 0xF).to(torch.int16) - 8).to(torch.float32)
    hi = ((packed >> 4).to(torch.int16) - 8).to(torch.float32)
    return q[:, 0::2] @ lo.t() + q[:, 1::2] @ hi.t()


def segmented_topc(score_segment: Callable[[int, int], torch.Tensor], n: int,
                   c: int, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-c over n columns scored `block` at a time.

    `score_segment(offset, rows)` returns the (Q, rows) masked score plane
    of columns [offset, offset + rows). Each segment's candidates are exact
    (lowest index first among ties; ``ops/topk.py::wide_candidates``), and
    the segments' lists merge under the same order, so the result is the
    exact top-c of the whole plane while one (Q, block) plane at a time is
    alive. Returns (values f32, indices int64), each (Q, min(c, n))."""
    cc = min(c, n)
    vals, idx = [], []
    for off in range(0, n, block):
        s = score_segment(off, min(block, n - off))
        v, i = resolve_ties(s, *wide_candidates(s, min(cc, s.shape[-1])))
        vals.append(v)
        idx.append(i + off)
    return two_key_topk(torch.cat(vals, 1), torch.cat(idx, 1), cc, True)


def screen_int4_topc(queries_bf16: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, valid: torch.Tensor, c: int,
                     block: int = 1 << 21) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-c int4 cosine screen in plain PyTorch, tiled in `block`-row
    slabs with a running top-c merge. `valid` rows score -inf (tombstones,
    attribute filters); callers treat -inf entries as padding. Returns
    (scores f32, indices int64), each (Q, min(c, N))."""

    def seg(off, rows):
        s = unpack2_dots(queries_bf16, packed[off: off + rows]) * scales[off: off + rows]
        return s.masked_fill(~valid[off: off + rows], float("-inf"))

    return segmented_topc(seg, packed.shape[0], c, block)


def rerank_int8_topk(queries: torch.Tensor, cand_rows: torch.Tensor,
                     cand_scales: torch.Tensor, cand_ok: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2 of the int4 tier: exact rerank of screened candidates.

    queries (Q, D) (unnormalized fine), cand_rows (Q, C, D) int8,
    cand_scales (Q, C) f32, cand_ok (Q, C) bool (False = screen padding).
    Returns (vals (Q, k), pos (Q, k)): pos indexes into C, lowest position
    first among ties (lax.top_k's order). The unit query is rounded to
    bf16 and multiplied with the int8 rows in f32 (exact products, f32
    sums), times the norm-preserving scale: the resident int8 sweep's math."""
    require_full_f32(cand_rows.device)
    qu = unit_queries(queries).to(torch.bfloat16).to(torch.float32)
    dots = torch.bmm(cand_rows.to(torch.float32), qu[:, :, None])[..., 0]
    scores = torch.where(cand_ok, dots * cand_scales, float("-inf"))
    return exact_topk(scores, k)
