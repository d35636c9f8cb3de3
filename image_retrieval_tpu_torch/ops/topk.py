"""Exact top-k with stable (lowest-index) tie-breaking.

Port of ``image_retrieval_tpu/ops/topk.py``. ``torch.topk`` does not promise
an order among equal scores, so the order is made explicit: a stable sort
keeps equal scores in ascending index order, and a slice takes the first k.
That is the JAX package's ``lax.top_k`` order, and a numpy
``argsort(kind="stable")`` oracle's.

Direction conventions: similarity metrics (cosine_similarity,
optimized_similarity) descend, distances ascend.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Metrics ranked descending (higher = better). Everything else ascends.
DESCENDING_METRICS = frozenset({"cosine_similarity", "optimized_similarity", "score"})


def exact_topk(scores: torch.Tensor, k: int,
               descending: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with deterministic lowest-index ties.

    Returns (values f32, indices int64), each (..., min(k, N))."""
    k = min(k, scores.shape[-1])
    s = scores.to(torch.float32)
    vals, idx = torch.sort(s, dim=-1, descending=descending, stable=True)
    return vals[..., :k], idx[..., :k]


def wide_candidates(scores: torch.Tensor, k: int, descending: bool = True):
    """The k best columns of each row of an (R, N) f32 plane, unordered
    among equal scores, and per row whether that matters.

    ``torch.topk`` of k + 1: when the (k+1)-th value differs from the k-th
    value t, every column equal to t is already among the k, so the set is
    exact. When they are equal, ties at t straddle the boundary and
    ``torch.topk`` chose among them in no promised order: the row is
    flagged for ``resolve_ties``. Returns (values, indices int64,
    flagged (R,) bool); small planes are sorted exactly, nothing flagged."""
    n = scores.shape[-1]
    if 4 * k >= n:
        vals, idx = exact_topk(scores, k, descending)
        return vals, idx, torch.zeros(scores.shape[0], dtype=torch.bool, device=scores.device)
    vals, idx = torch.topk(scores, k + 1, dim=-1, largest=descending, sorted=True)
    return vals[:, :k], idx[:, :k], vals[:, k] == vals[:, k - 1]


def resolve_ties(scores, vals, idx, flagged, descending: bool = True):
    """Make the flagged rows of a ``wide_candidates`` result exact, in
    place: every score strictly better than the k-th value t, then the
    lowest-index columns equal to t (a cumulative count of the row's ties,
    one row at a time: the rare case, and the usual one only when t is the
    -inf of masked columns). One host sync, for the flags."""
    k = vals.shape[-1]
    for r in torch.nonzero(flagged).flatten().tolist():
        row, t = scores[r], vals[r, k - 1]
        eq = row == t
        need = k - int((row > t if descending else row < t).sum())
        pick = torch.nonzero((row > t if descending else row < t)
                             | (eq & (torch.cumsum(eq.to(torch.int32), 0) <= need))).flatten()
        idx[r], vals[r] = pick, row[pick]
    return vals, idx


def exact_topk_wide(scores: torch.Tensor, k: int,
                    descending: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``exact_topk``'s result for (R, N) planes with N far larger than k.

    ``exact_topk`` sorts every column: 5.49 ms for 64 x 1M on an H100
    (PERF.md section 5), more than the sweep that made the plane. Here
    ``wide_candidates`` selects with ``torch.topk``, ``resolve_ties``
    fixes the rare rows whose ties cross the boundary, and
    ``two_key_topk`` orders the k survivors (score, then ascending index).
    Returns (values f32, indices int64), each (R, min(k, N))."""
    k = min(k, scores.shape[-1])
    s = scores.to(torch.float32)
    vals, idx = resolve_ties(s, *wide_candidates(s, k, descending), descending)
    return two_key_topk(vals, idx, k, descending)


def two_key_topk(vals: torch.Tensor, idx: torch.Tensor, k: int,
                 descending: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (vals, idx) candidate lists under the canonical (score,
    ascending index) order — the merge every shard/slice combiner uses.
    Sorts on the index first, then stable-sorts on the score."""
    order_idx = torch.argsort(idx, dim=-1, stable=True)
    s2 = torch.gather(vals, -1, order_idx)
    order_val = torch.argsort(s2, dim=-1, descending=descending, stable=True)
    top = torch.gather(order_idx, -1, order_val)[..., : min(k, vals.shape[-1])]
    return torch.gather(vals, -1, top), torch.gather(idx, -1, top)


def merge_topk(values_a, indices_a, values_b, indices_b, k: int,
               descending: bool = True):
    """Merge two partial top-k lists; ties resolve to the lower global index."""
    return two_key_topk(torch.cat([values_a, values_b], -1),
                        torch.cat([indices_a, indices_b], -1), k, descending)
