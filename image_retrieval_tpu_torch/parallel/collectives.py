"""The index's search collectives on one device.

Port of ``image_retrieval_tpu/parallel/collectives.py`` for a single shard:
the gallery is not split, so each function is its shard-local body followed
by the k-sized merge, which on one shard only restores the canonical order
(score, then ascending row index). Multi-device (a row-sharded gallery with
an NCCL merge) comes with ROADMAP.md queue 1 item 10.

``sharded_search_topk`` (every metric), ``sharded_multimetric_topk`` and
``sharded_scores`` serve the f32, bf16 and int8 tiers;
``sharded_int4_screen_topk`` and ``sharded_int4_two_phase_topk`` the int4
tier. Where the JAX package computes a sweep with exactly the function of
one of its TPU kernels, the sweep goes through the Hopper kernel on the
card and the kernel's plain version on the CPU:

- int8 rows, ``optimized_similarity``: ``fused_optimized_scores_int8_pallas``
  (K5), whose contract is ``ops/metrics.py::fused_optimized_scores_int8``;
- the five planes of ``sharded_multimetric_topk``: ``fused_all_metrics``
  (K6), over bf16 and int8 galleries ``ROW_BLOCK`` dequantized rows at a
  time;
- the int4 screen: ``int4_screen_topc`` (K3; K12 under the query form
  ``"i8"``, which no tier selects).

Everything else is plain tensor operations in row blocks, as the JAX
package leaves it to XLA: the f32/bf16 weighted score uses the direct L2
(``fused_optimized_scores_xla(exact_l2=True)``), which the Gram-form
kernels K4 and K7 do not compute.

``selector="approx"`` (``IndexConfig.approx_select``) and ``shadow=`` (the
bf16 ``l1_shadow`` rows) are accepted and change nothing. Off a TPU the JAX
package's approximate selector lowers to an exact top-k, so its answers are
the exact selector's; and its shadow scorer computes the int8 weighted
score (bit for bit the plain version's on the CPU) in tensor operations over
a bf16 copy of the gallery, 47 times K5's time at 64 queries on an NVIDIA
H100 80GB HBM3, 700.00 W (ROADMAP.md). Every call here takes the exact path
and K5.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from image_retrieval_tpu_torch.device import require_full_f32
from image_retrieval_tpu_torch.ops.fused_metrics import (
    PLANES,
    fused_all_metrics,
    fused_optimized_scores_int8_pallas,
)
from image_retrieval_tpu_torch.ops.int4 import unit_queries
from image_retrieval_tpu_torch.ops.int4_screen import int4_screen_topc
from image_retrieval_tpu_torch.ops.metrics import (
    METRIC_NAMES,
    _safe_div,
    fused_optimized_scores_xla,
    pairwise_metrics,
)
from image_retrieval_tpu_torch.ops.topk import (
    DESCENDING_METRICS,
    exact_topk,
    exact_topk_wide,
    two_key_topk,
)

# Rows upcast or dequantized to f32 per block in the bf16/int8 sweeps: no
# (N, D) f32 copy of the gallery is made (a 2^16 x 512 block is 128 MiB).
ROW_BLOCK = 1 << 16

# Query form of the int4 screen on the index's sweeps
# (ops/int4_screen.py::int4_screen_topc): "bf16" scores as unpack2_dots does;
# "i8" quantizes each query to int8 and takes the integer kernel. As in the
# JAX package it stays "bf16" until "i8" is measured faster on the card at
# equal recall.
INT4_SCREEN_QFORM = "bf16"

_ANGLE_FAMILY = ("cosine_similarity", "cosine_distance", "angular_distance")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to image_retrieval_tpu_torch yet (see ROADMAP.md)")


def _row_dots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, D) f32 x (N, D) rows of any dtype -> (Q, N) f32 products of the
    rows upcast to f32, ROW_BLOCK rows at a time."""
    if rows.dtype == torch.float32:
        return q @ rows.t()
    out = torch.empty((q.shape[0], rows.shape[0]), dtype=torch.float32, device=q.device)
    for off in range(0, rows.shape[0], ROW_BLOCK):
        out[:, off: off + ROW_BLOCK] = q @ rows[off: off + ROW_BLOCK].to(torch.float32).t()
    return out


def _score_block(queries: torch.Tensor, gallery: torch.Tensor,
                 mags: Optional[torch.Tensor], metric: str,
                 weights: Optional[Tuple[float, ...]]) -> torch.Tensor:
    """(Q, D) x (Nb, D) f32 unit rows -> (Q, Nb) scores.

    `mags` carries the stored magnitudes: the metrics that need
    unnormalized geometry (L1/L2/Linf/magnitude and the optimized combo)
    are computed on the magnitude-rescaled rows. The cosine family reads
    the unit rows directly, cos = <g, q> / ||q||; the other single metrics
    go through pairwise_metrics on g * m, L2 in its Gram form with the row
    norms recomputed."""
    if metric == "optimized_similarity":
        m = mags if mags is not None else torch.ones(
            gallery.shape[0], dtype=torch.float32, device=gallery.device)
        return fused_optimized_scores_xla(queries, gallery, m, weights)
    if metric in _ANGLE_FAMILY:
        q = queries.to(torch.float32)
        qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        cos = _safe_div(q @ gallery.t(), qn)
        if metric == "cosine_similarity":
            return cos
        if metric == "cosine_distance":
            return 1.0 - cos
        return torch.arccos(torch.clamp(cos, -1.0, 1.0))
    if metric not in METRIC_NAMES:
        raise ValueError(f"unknown metric {metric!r}: one of {METRIC_NAMES} or "
                         "'optimized_similarity'")
    g = gallery if mags is None else gallery * mags[:, None]
    return pairwise_metrics(queries, g, metrics=(metric,))[metric]


def _generic_scores(q, g, m, sc, metric, weights) -> torch.Tensor:
    """_score_block over a gallery of any tier: f32 rows in one call where
    that makes no copy of them (the cosine family and the optimized score,
    which walks row blocks itself), everything else ROW_BLOCK rows at a
    time, upcast and (int8) multiplied by their scales first."""
    n = g.shape[0]
    plain_f32 = g.dtype == torch.float32 and sc is None
    if plain_f32 and (metric in _ANGLE_FAMILY or metric == "optimized_similarity"):
        return _score_block(q, g, m, metric, weights)
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=q.device)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(lo + ROW_BLOCK, n)
        rows = g[lo:hi].to(torch.float32)
        if sc is not None:
            rows = rows * sc[lo:hi, None]
        out[:, lo:hi] = _score_block(q, rows, None if m is None else m[lo:hi], metric, weights)
    return out


def _masked_shard_scores(q, g, v, m, sc, metric, weights, descending) -> torch.Tensor:
    """(Q, N) scores of the gallery, rows where `v` is False masked to the
    metric's worst score (-inf descending, +inf ascending). `m` the
    magnitudes or None, `sc` the int8 scales or None."""
    if sc is not None and metric == "optimized_similarity":
        # int8 fast path: angle, L2 and magnitude terms off one product of
        # the bf16 query with the int8 values (the norm-preserving scales
        # make the Gram-form L2 exact); only live L1/Linf terms sweep the
        # differences, in bf16. The kernel on the card.
        mm = m if m is not None else torch.ones(g.shape[0], dtype=torch.float32,
                                                device=g.device)
        scores = fused_optimized_scores_int8_pallas(q, g, sc, mm, weights)
    elif sc is not None and metric == "cosine_similarity":
        # int8 fast path: the unit query rounded to bf16 x the int8 rows,
        # the per-row scale applied to the (Q, N) result
        qu = unit_queries(q).to(torch.bfloat16).to(torch.float32)
        scores = _row_dots(qu, g) * sc
    else:
        scores = _generic_scores(q, g, m, sc, metric, weights)
    return scores.masked_fill_(~v, float("-inf") if descending else float("inf"))


def sharded_search_topk(queries: torch.Tensor, gallery: torch.Tensor,
                        valid: torch.Tensor, mags: Optional[torch.Tensor], k: int,
                        metric: str = "cosine_similarity",
                        weights: Optional[Tuple[float, ...]] = None,
                        scales: Optional[torch.Tensor] = None,
                        shadow: Optional[torch.Tensor] = None, *,
                        selector: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the gallery for any metric.

    queries (Q, D); gallery (N, D) f32, bf16 or int8 unit rows; valid (N,)
    bool; mags (N,) stored magnitudes or None; weights the 5-tuple
    (w_angle, w_l1, w_l2, w_inf, w_mag) when metric is
    "optimized_similarity"; scales the (N,) int8 norm-preserving scales.
    Similarities rank descending, distances ascending; equal scores by
    ascending row. `shadow` and selector "approx" are accepted and give the
    exact answers (module docstring). Returns (values (Q, kk) f32, indices
    (Q, kk) int64), kk = min(k, N)."""
    if selector not in ("exact", "approx"):
        raise ValueError(f"selector must be 'exact' or 'approx', got {selector!r}")
    require_full_f32(gallery.device)
    descending = metric in DESCENDING_METRICS
    scores = _masked_shard_scores(queries, gallery, valid, mags, scales, metric, weights,
                                  descending)
    return exact_topk_wide(scores, min(k, gallery.shape[0]), descending)


def sharded_multimetric_topk(queries: torch.Tensor, gallery: torch.Tensor,
                             valid: torch.Tensor, mags: torch.Tensor, k: int,
                             scales: Optional[torch.Tensor] = None,
                             ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Per-metric exact top-k for all five metrics in one gallery pass.

    Returns {metric: (values (Q, kk), indices (Q, kk))} for
    cosine_similarity (descending) and the l1/l2/linf/magnitude distances
    (ascending, +inf where `valid` is False), L2 from the explicit
    differences. The planes are fused_all_metrics (the kernel on the
    card): over the whole gallery for f32 rows, over ROW_BLOCK rows
    upcast (bf16) or dequantized (int8 x scale) at a time otherwise."""
    require_full_f32(gallery.device)
    q = queries.to(torch.float32)
    n = gallery.shape[0]
    if gallery.dtype == torch.float32 and scales is None:
        planes = fused_all_metrics(q, gallery, mags)
    else:
        planes = torch.empty((len(PLANES), q.shape[0], n), dtype=torch.float32,
                             device=q.device)
        for lo in range(0, n, ROW_BLOCK):
            hi = min(lo + ROW_BLOCK, n)
            rows = gallery[lo:hi].to(torch.float32)
            if scales is not None:
                rows = rows * scales[lo:hi, None]
            planes[:, :, lo:hi] = fused_all_metrics(q, rows, mags[lo:hi])
    out = {}
    for plane, name in zip(planes, PLANES):
        descending = name in DESCENDING_METRICS
        plane.masked_fill_(~valid, float("-inf") if descending else float("inf"))
        out[name] = exact_topk_wide(plane, min(k, n), descending)
    return out


def sharded_scores(queries: torch.Tensor, gallery: torch.Tensor,
                   mags: Optional[torch.Tensor], metric: str,
                   weights: Optional[Tuple[float, ...]] = None,
                   scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (Q, N) score matrix, for analysis-scale galleries. int8 rows are
    dequantized to f32 and scored by the f32 functions (not the int8 fast
    paths sharded_search_topk takes: the two differ at the int8/bf16
    rounding level, ~1e-3, by design)."""
    require_full_f32(gallery.device)
    return _generic_scores(queries.to(torch.float32), gallery, mags, scales, metric, weights)


def sharded_int4_screen_topk(queries: torch.Tensor, packed: torch.Tensor,
                             valid: torch.Tensor, scales: torch.Tensor,
                             c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine screen over the nibble-packed gallery: top-min(c, N) per
    query of the int4 approximate scores. Queries are normalized with the
    zero-norm guard and cast to bf16. Rows where `valid` is False score
    -inf and surface only as padding. Returns (scores (Q, cc) f32, row
    indices (Q, cc) int64). One device; multi-device comes with ROADMAP.md
    queue 1 item 10."""
    cc = min(c, packed.shape[0])
    qu = unit_queries(queries).to(torch.bfloat16)
    return int4_screen_topc(qu, packed, scales, valid, cc, qform=INT4_SCREEN_QFORM)


def sharded_int4_two_phase_topk(queries: torch.Tensor, packed: torch.Tensor,
                                valid: torch.Tensor, scales: torch.Tensor,
                                rows8: torch.Tensor, scales8: torch.Tensor,
                                c: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int4 two-phase search with the int8 rows on the device
    (IndexConfig.rerank_device): screen top-cc, gather the candidates'
    int8 rows on the device, rerank exactly (bf16-rounded unit query x int8
    rows, f32 sums, x the int8 scale; screen padding -inf), top-kk with the
    lowest candidate position first among ties, then the merge's canonical
    order. Returns (scores (Q, kk) f32, row indices (Q, kk) int64). One
    device; multi-device comes with ROADMAP.md queue 1 item 10."""
    require_full_f32(rows8.device)
    cc = min(c, packed.shape[0])
    kk = min(k, cc)
    qu = unit_queries(queries).to(torch.bfloat16)
    sv, sidx = int4_screen_topc(qu, packed, scales, valid, cc, qform=INT4_SCREEN_QFORM)
    cand = rows8[sidx].to(torch.float32)  # (Q, cc, D)
    ex = torch.bmm(cand, qu.to(torch.float32)[:, :, None])[..., 0] * scales8[sidx]
    ex = torch.where(torch.isfinite(sv), ex, float("-inf"))
    vals, pos = exact_topk(ex, kk)
    return two_key_topk(vals, torch.gather(sidx, 1, pos), k, True)
