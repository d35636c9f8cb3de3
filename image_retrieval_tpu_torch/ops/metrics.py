"""Batched geometric similarity metrics in plain PyTorch, f32 accumulation.

Port of ``image_retrieval_tpu/ops/metrics.py`` (pure XLA there, so plain
tensor operations here):

  pairwise_metrics : (Q, D) x (N, D) -> {metric: (Q, N)}
  pair_metrics     : (P, D) x (P, D) -> {metric: (P,)}     row-aligned pairs

with the reference's semantics and dimension normalizations:

  cosine_similarity      0 when a norm is 0
  angular_distance       arccos(clip(cos, -1, 1))
  cosine_distance        1 - cos
  l1_distance            sum|a-b| / D
  l2_distance            sqrt(sum (a-b)^2) / sqrt(D)
  linf_distance          max|a-b|
  magnitude_difference   | ||a|| - ||b|| |
  optimized_similarity   w_angle*cos - w_l1*L1 - w_l2*L2 - w_inf*Linf - w_mag*dmag
  optimized_distance     -optimized_similarity

The L1/L2/Linf terms need the (Q, rows, D) differences. The JAX package
leaves the fusion of that broadcast to XLA; here every function that forms
it walks the gallery in row blocks, so the broadcast never exceeds
``BROADCAST_ELEMS`` elements whatever the gallery's size. The hand-written
single-pass kernels for the card are in ``ops/fused_metrics.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

METRIC_NAMES = (
    "cosine_similarity",
    "cosine_distance",
    "angular_distance",
    "l1_distance",
    "l2_distance",
    "linf_distance",
    "magnitude_difference",
)

# The five "distance" metrics used by the MI analysis engine.
ANALYSIS_METRICS = (
    "cosine_distance",
    "l1_distance",
    "l2_distance",
    "linf_distance",
    "magnitude_difference",
)

WEIGHT_KEYS = ("w_angle", "w_l1", "w_l2", "w_inf", "w_mag")

# Most elements of one (Q, rows, D) difference block (f32: 512 MiB).
BROADCAST_ELEMS = 1 << 27


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def live(w) -> bool:
    """A weight takes part unless it is a Python number equal to 0: dead
    terms are dropped before any work is done for them (a dead Linf or L1
    is a whole sweep saved). A tensor weight is always live."""
    return not (isinstance(w, (int, float)) and float(w) == 0.0)


def _dim_f32(x: torch.Tensor) -> torch.Tensor:
    """D as an f32 tensor: dividing by a tensor is a correctly rounded
    division on every device (CUDA turns division by a Python scalar into
    a multiplication by its reciprocal)."""
    return torch.full((), float(x.shape[-1]), dtype=torch.float32, device=x.device)


def _safe_div(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """num / denom where denom > 0, else 0 (a zero norm gives cosine 0)."""
    ok = denom > 0
    return torch.where(ok, num / torch.where(ok, denom, 1.0), 0.0)


def row_blocks(n: int, nq: int, d: int, block_n: Optional[int] = None):
    """(lo, hi) row ranges whose (nq, rows, d) broadcast stays within
    BROADCAST_ELEMS (and within `block_n` rows when given)."""
    step = max(1, BROADCAST_ELEMS // max(nq * d, 1))
    if block_n is not None:
        step = min(step, max(int(block_n), 1))
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)] or [(0, 0)]


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cosine similarity (Q, D) x (N, D) -> (Q, N); 0 where either
    vector has zero norm."""
    a, b = _f32(a), _f32(b)
    na = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    nb = torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return _safe_div(a @ b.t(), na * nb.t())


_ANGLE_FAMILY = ("cosine_similarity", "cosine_distance", "angular_distance")


def _pairwise_block(q, g, nq, ng, metrics, exact_l2):
    """Requested metrics of a (Q, D) x (Nb, D) block; nq (Q, 1) query norms,
    ng (Nb,) row norms."""
    out = {}
    d = _dim_f32(q)
    need_dots = any(m in metrics for m in _ANGLE_FAMILY) or (
        "l2_distance" in metrics and not exact_l2)
    if need_dots:
        dots = q @ g.t()
        cos = _safe_div(dots, nq * ng[None, :])
        if "cosine_similarity" in metrics:
            out["cosine_similarity"] = cos
        if "cosine_distance" in metrics:
            out["cosine_distance"] = 1.0 - cos
        if "angular_distance" in metrics:
            out["angular_distance"] = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        if "l2_distance" in metrics and not exact_l2:
            # ||a-b||^2 = ||a||^2 + ||b||^2 - 2<a,b> (Gram form)
            sq = torch.clamp(nq * nq + (ng * ng)[None, :] - 2.0 * dots, min=0.0)
            out["l2_distance"] = torch.sqrt(sq) / torch.sqrt(d)
    need_diff = any(m in metrics for m in ("l1_distance", "linf_distance")) or (
        "l2_distance" in metrics and exact_l2)
    if need_diff:
        diff = torch.abs(q[:, None, :] - g[None, :, :])  # (Q, Nb, D)
        if "l1_distance" in metrics:
            out["l1_distance"] = diff.sum(-1) / d
        if "linf_distance" in metrics:
            out["linf_distance"] = diff.amax(-1)
        if "l2_distance" in metrics and exact_l2:
            out["l2_distance"] = torch.sqrt((diff * diff).sum(-1)) / torch.sqrt(d)
    if "magnitude_difference" in metrics:
        out["magnitude_difference"] = torch.abs(nq - ng[None, :])
    return out


def pairwise_metrics(queries: torch.Tensor, gallery: torch.Tensor,
                     metrics: Sequence[str] = METRIC_NAMES, exact_l2: bool = False,
                     block_n: int = 4096) -> Dict[str, torch.Tensor]:
    """All requested metrics for every (query, gallery row) pair.

    queries (Q, D), gallery (N, D); `metrics` a subset of METRIC_NAMES;
    `exact_l2` takes L2 from explicit differences instead of the Gram
    form; `block_n` bounds the rows of one (Q, block, D) broadcast.
    Returns {metric: (Q, N) float32}."""
    metrics = tuple(metrics)
    q, g = _f32(queries), _f32(gallery)
    nq = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ng = torch.linalg.vector_norm(g, dim=-1)
    blocks = row_blocks(g.shape[0], q.shape[0], q.shape[1], block_n)
    if len(blocks) == 1:
        return _pairwise_block(q, g, nq, ng, metrics, exact_l2)
    out = {m: torch.empty((q.shape[0], g.shape[0]), dtype=torch.float32, device=q.device)
           for m in metrics}
    for lo, hi in blocks:
        part = _pairwise_block(q, g[lo:hi], nq, ng[lo:hi], metrics, exact_l2)
        for m in metrics:
            out[m][:, lo:hi] = part[m]
    return out


def pair_metrics(a: torch.Tensor, b: torch.Tensor,
                 metrics: Sequence[str] = METRIC_NAMES) -> Dict[str, torch.Tensor]:
    """Row-aligned metrics: a[i] vs b[i] -> {metric: (P,)}."""
    metrics = tuple(metrics)
    a, b = _f32(a), _f32(b)
    d = _dim_f32(a)
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    out = {}
    if any(m in metrics for m in _ANGLE_FAMILY):
        cos = _safe_div((a * b).sum(-1), na * nb)
        if "cosine_similarity" in metrics:
            out["cosine_similarity"] = cos
        if "cosine_distance" in metrics:
            out["cosine_distance"] = 1.0 - cos
        if "angular_distance" in metrics:
            out["angular_distance"] = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    if any(m in metrics for m in ("l1_distance", "l2_distance", "linf_distance")):
        diff = torch.abs(a - b)
        if "l1_distance" in metrics:
            out["l1_distance"] = diff.sum(-1) / d
        if "l2_distance" in metrics:
            out["l2_distance"] = torch.sqrt((diff * diff).sum(-1)) / torch.sqrt(d)
        if "linf_distance" in metrics:
            out["linf_distance"] = diff.amax(-1)
    if "magnitude_difference" in metrics:
        out["magnitude_difference"] = torch.abs(na - nb)
    return out


def optimized_similarity_from_metrics(m: Dict[str, torch.Tensor],
                                      params: Dict[str, float]) -> torch.Tensor:
    """Weighted similarity from precomputed metrics, (Q, N) or (P,) shapes.
    One metric tensor serves many weight combinations (the grid search)."""
    return (
        params.get("w_angle", 1.0) * m["cosine_similarity"]
        - params.get("w_l1", 0.0) * m["l1_distance"]
        - params.get("w_l2", 0.0) * m["l2_distance"]
        - params.get("w_inf", 0.0) * m["linf_distance"]
        - params.get("w_mag", 0.0) * m["magnitude_difference"]
    )


def gram_sq(m: torch.Tensor, udots: torch.Tensor, qn: torch.Tensor) -> torch.Tensor:
    """||m g - q||^2 = m^2 - 2 m <g, q> + ||q||^2 for unit rows g, clamped
    at 0: (Q, N) from m (N,), udots (Q, N) = <g, q>, qn (Q, 1). The
    operations and their order are the contract the fused kernels repeat."""
    m = m[None, :]
    return torch.clamp(m * m - (2.0 * m) * udots + qn * qn, min=0.0)


def fused_optimized_scores_xla(queries: torch.Tensor, gallery_unit: torch.Tensor,
                               magnitudes: torch.Tensor, weights,
                               exact_l2: bool = True,
                               block_n: Optional[int] = None) -> torch.Tensor:
    """Weighted optimized-similarity over a (unit vector, magnitude) gallery,
    the scorer of the f32 and bf16 index tiers (the name is the JAX
    package's, where XLA fuses it; here it is plain tensor operations in
    row blocks).

    queries (Q, D); gallery_unit (N, D); magnitudes (N,); weights a
    5-sequence ordered (w_angle, w_l1, w_l2, w_inf, w_mag), each a Python
    number or a 0-d tensor. Terms whose weight is a Python number equal to
    0 are not computed. Returns (Q, N) f32."""
    q, m = _f32(queries), _f32(magnitudes)
    d = _dim_f32(q)
    w_angle, w_l1, w_l2, w_inf, w_mag = weights
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)  # (Q, 1)
    need_dots = live(w_angle) or (live(w_l2) and not exact_l2)
    sweep = live(w_l1) or live(w_inf) or (live(w_l2) and exact_l2)
    n = gallery_unit.shape[0]
    score = torch.zeros((q.shape[0], n), dtype=torch.float32, device=q.device)
    blocks = row_blocks(n, q.shape[0], q.shape[1], block_n) if sweep else [(0, n)]
    for lo, hi in blocks:
        g, mb, s = _f32(gallery_unit[lo:hi]), m[lo:hi], score[:, lo:hi]
        if need_dots:
            dots = q @ g.t()
        if live(w_angle):
            s += w_angle * _safe_div(dots, qn)
        if sweep:
            diff = (g * mb[:, None])[None, :, :] - q[:, None, :]  # (Q, Nb, D)
            ad = torch.abs(diff)
            if live(w_l1):
                s -= w_l1 * (ad.sum(-1) / d)
            if live(w_inf):
                s -= w_inf * ad.amax(-1)
            if live(w_l2) and exact_l2:
                s -= w_l2 * (torch.sqrt((diff * diff).sum(-1)) / torch.sqrt(d))
        if live(w_l2) and not exact_l2:
            s -= w_l2 * (torch.sqrt(gram_sq(mb, dots, qn)) / torch.sqrt(d))
        if live(w_mag):
            s -= w_mag * torch.abs(mb[None, :] - qn)
    return score


def _int8_scores(queries, gallery_int8, scales, magnitudes, weights, shadow,
                 block_n):
    q, m, sc = _f32(queries), _f32(magnitudes), _f32(scales)
    d = _dim_f32(q)
    w_angle, w_l1, w_l2, w_inf, w_mag = weights
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q16 = q.to(torch.bfloat16)
    need_dots = live(w_angle) or live(w_l2)
    sweep = live(w_l1) or live(w_inf)
    n = gallery_int8.shape[0]
    score = torch.zeros((q.shape[0], n), dtype=torch.float32, device=q.device)
    blocks = row_blocks(n, q.shape[0], q.shape[1], block_n)
    for lo, hi in blocks:
        mb, s = m[lo:hi], score[:, lo:hi]
        if need_dots:
            # bf16 x bf16 products are exact in f32; the sums are f32
            dots = _f32(q16) @ _f32(gallery_int8[lo:hi]).t()
            udots = dots * sc[None, lo:hi]  # <q, unit row>
        if live(w_angle):
            s += w_angle * _safe_div(udots, qn)
        if live(w_l2):
            s -= w_l2 * (torch.sqrt(gram_sq(mb, udots, qn)) / torch.sqrt(d))
        if sweep:
            if shadow is None:
                rec = make_l1_shadow(gallery_int8[lo:hi], sc[lo:hi], mb)
            else:
                rec = shadow[lo:hi]
            ad = torch.abs(rec[None, :, :] - q16[:, None, :])  # (Q, Nb, D) bf16
            if live(w_l1):
                s -= w_l1 * (ad.sum(-1, dtype=torch.float32) / d)
            if live(w_inf):
                s -= w_inf * _f32(ad.amax(-1))
        if live(w_mag):
            s -= w_mag * torch.abs(mb[None, :] - qn)
    return score


def fused_optimized_scores_int8(queries: torch.Tensor, gallery_int8: torch.Tensor,
                                scales: torch.Tensor, magnitudes: torch.Tensor,
                                weights, block_n: Optional[int] = None) -> torch.Tensor:
    """Weighted optimized-similarity over an int8 gallery without
    dequantizing rows to f32.

    The index stores norm-preserving per-row scales: ``int8_row * scale``
    has unit norm, so the reconstructed row ``int8_row * scale * mag`` has
    norm ``mag`` and the angle and L2 terms come off one product of the
    bf16-rounded query with the int8 values:

        cos  = scale * <int8_row, q> / ||q||
        L2^2 = mag^2 - 2*mag*scale*<int8_row, q> + ||q||^2

    Only live L1/Linf terms sweep the (Q, N, D) differences, in bf16 (the
    int8 values and their products with a bf16 row scale are rounded once;
    the sums are f32). Matches the f32 scorer on the dequantized rows up
    to int8/bf16 rounding (~1e-3 relative)."""
    return _int8_scores(queries, gallery_int8, scales, magnitudes, weights, None, block_n)


def make_l1_shadow(gallery_int8: torch.Tensor, scales: torch.Tensor,
                   magnitudes: torch.Tensor) -> torch.Tensor:
    """(N, D) bf16 pre-dequantized rows for the L1/Linf sweep of
    fused_optimized_scores_int8_shadow. The bf16 product
    ``int8 * bf16(scale*mag)`` rounds the same whether it is stored once
    or recomputed per sweep, so the shadow path is bit-identical to
    fused_optimized_scores_int8."""
    row_scale = (_f32(scales) * _f32(magnitudes)).to(torch.bfloat16)
    return gallery_int8.to(torch.bfloat16) * row_scale[:, None]


def fused_optimized_scores_int8_shadow(queries: torch.Tensor, gallery_int8: torch.Tensor,
                                       scales: torch.Tensor, magnitudes: torch.Tensor,
                                       shadow: torch.Tensor, weights,
                                       block_n: Optional[int] = None) -> torch.Tensor:
    """fused_optimized_scores_int8 with the L1/Linf sweep reading a
    pre-dequantized bf16 shadow gallery (make_l1_shadow). Same results
    bitwise; with a dead sweep it is the int8 scorer exactly."""
    return _int8_scores(queries, gallery_int8, scales, magnitudes, weights, shadow, block_n)


_OPTIMIZED_NEEDS = ("cosine_similarity", "l1_distance", "l2_distance", "linf_distance",
                    "magnitude_difference")


def optimized_similarity(queries: torch.Tensor, gallery: torch.Tensor,
                         params: Dict[str, float]) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) weighted similarity (higher = more similar)."""
    m = pairwise_metrics(queries, gallery, metrics=_OPTIMIZED_NEEDS)
    return optimized_similarity_from_metrics(m, params)


def optimized_distance(queries: torch.Tensor, gallery: torch.Tensor,
                       params: Dict[str, float]) -> torch.Tensor:
    """Negated optimized similarity."""
    return -optimized_similarity(queries, gallery, params)


def create_parameter_grid(granularity: int = 5) -> Dict[str, list]:
    """Uniform [0, 1] weight grid."""
    values = np.linspace(0.0, 1.0, granularity)
    return {k: list(values) for k in WEIGHT_KEYS}
