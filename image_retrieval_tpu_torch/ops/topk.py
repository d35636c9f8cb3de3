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
