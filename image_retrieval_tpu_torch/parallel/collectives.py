"""The index's search collectives over a mesh of devices.

Port of ``image_retrieval_tpu/parallel/collectives.py``. The gallery's rows
are split in equal blocks over the mesh's row axis (``parallel/mesh.py``):
each shard scores its block on its own device and reduces it to a local
top-k; only those (Q, k) candidate lists travel, gathered in shard order
onto the merging device and reduced by ``two_key_topk`` (score, then
ascending global row), the JAX package's ``all_gather(tiled=True)`` merge.
A shard's local row r is global row ``shard * rows_per_shard + r``. A
multi-slice row axis ('slice', 'data') merges hierarchically, each slice's
shards first, then the slices: k candidates a slice cross between slices.
Without a mesh a function runs on the gallery's device as one shard.

Inputs with rows are whole tensors (split here with ``shard_rows``) or
lists of per-shard tensors already on their devices, as the index holds
them; a list without a mesh merges flat over its shards.

``sharded_search_topk`` (every metric), ``sharded_multimetric_topk``,
``multislice_search_topk`` and ``sharded_scores`` serve the f32, bf16 and
int8 tiers; ``sharded_int4_screen_topk`` and ``sharded_int4_two_phase_topk``
the int4 tier. Where the JAX package computes a shard's sweep with exactly
the function of one of its TPU kernels, the sweep goes through the Hopper
kernel on the card and the kernel's plain version on the CPU:

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

Streams and devices: each shard's work is queued on its device's current
stream with that device made current (``mesh.on_device``), so a kernel
wrapper launches where its pointers live. The gather is ``Tensor.to`` of
each shard's candidates, which PyTorch orders after the work queued on the
source device's current stream and before later work on the destination's:
work that a shard put on another stream would need an event the merge
waits on. Shards on one device (virtual meshes) run one after another on
its stream.

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

from typing import Dict, List, Optional, Sequence, Tuple

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
from image_retrieval_tpu_torch.parallel.mesh import (
    Axis,
    Mesh,
    axis_names,
    on_device,
    shard_devices,
    shard_rows,
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



# -- the split and the merge --------------------------------------------------


class _Split:
    """Where a call's shards live: their devices in shard order and the
    sizes of the row axes (innermost last), which the merge walks."""

    def __init__(self, gallery, mesh: Optional[Mesh], axis: Axis):
        self.mesh, self.axis = mesh, axis
        if mesh is not None:
            self.devices = shard_devices(mesh, axis)
            self.sizes = [mesh.shape[a] for a in axis_names(axis)]
        elif isinstance(gallery, (list, tuple)):
            self.devices = [g.device for g in gallery]
            self.sizes = [len(gallery)]
        else:
            self.devices, self.sizes = [gallery.device], [1]
        self.gallery = self.rows(gallery)
        self.nlocal = self.gallery[0].shape[0]

    def rows(self, x) -> List[Optional[torch.Tensor]]:
        """`x` as one tensor a shard: None, a list of shards, or a whole
        tensor split over the mesh."""
        if x is None:
            return [None] * len(self.devices)
        if isinstance(x, (list, tuple)):
            if len(x) != len(self.devices):
                raise ValueError(f"{len(x)} shards for {len(self.devices)} devices")
            return list(x)
        if self.mesh is None:
            return [x]
        return shard_rows(x, self.mesh, self.axis)

    def queries(self, q: torch.Tensor, s: int) -> torch.Tensor:
        """The replicated queries on shard s's device."""
        return q.to(self.devices[s])

    def each(self):
        """(shard, device) with the device current and its f32 products
        checked."""
        for s, dev in enumerate(self.devices):
            with on_device(dev):
                require_full_f32(dev)
                yield s, dev

    def offset(self, idx: torch.Tensor, s: int) -> torch.Tensor:
        """A shard's local row indices as global ones."""
        return idx + s * self.nlocal if s else idx


def _merge(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], split: _Split, k: int,
           descending: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard (values (Q, kk), global indices (Q, kk)), in shard order ->
    the merged top-k on the first shard's device, in the canonical (score,
    ascending index) order.

    Innermost row axis first: each group of shards along it is concatenated
    in shard order on the group's first device and reduced by two_key_topk
    (the JAX package's tiled all_gather and merge), then the groups along
    the next axis out. The order is total, so the levels give the flat
    merge's answer. The copies are Tensor.to (module docstring)."""
    parts, devs = list(parts), list(split.devices)
    for size in reversed(split.sizes):
        if size == 1 and len(parts) > 1:
            continue
        merged, heads = [], []
        for g in range(0, len(parts), size):
            dst = devs[g]
            vals = torch.cat([v.to(dst) for v, _ in parts[g: g + size]], -1)
            idx = torch.cat([i.to(dst) for _, i in parts[g: g + size]], -1)
            merged.append(two_key_topk(vals, idx, k, descending))
            heads.append(dst)
        parts, devs = merged, heads
        if len(parts) == 1:
            break
    return parts[0]


# -- the collectives ----------------------------------------------------------


def sharded_search_topk(queries: torch.Tensor, gallery, valid, mags, k: int,
                        metric: str = "cosine_similarity",
                        weights: Optional[Tuple[float, ...]] = None,
                        scales=None, shadow=None, *, mesh: Optional[Mesh] = None,
                        axis: Axis = "data",
                        selector: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded gallery for any metric.

    queries (Q, D); gallery (N, D) f32, bf16 or int8 unit rows; valid (N,)
    bool; mags (N,) stored magnitudes or None; weights the 5-tuple
    (w_angle, w_l1, w_l2, w_inf, w_mag) when metric is
    "optimized_similarity"; scales the (N,) int8 norm-preserving scales.
    Each shard scores its rows (tombstones -inf descending, +inf
    ascending) and keeps its top-kk, kk = min(k, rows per shard); the merge
    keeps k. Similarities rank descending, distances ascending; equal
    scores by ascending global row. `shadow` and selector "approx" are
    accepted and give the exact answers (module docstring). Returns
    (values (Q, k') f32, indices (Q, k') int64) on the first shard's
    device, k' = min(k, N)."""
    if selector not in ("exact", "approx"):
        raise ValueError(f"selector must be 'exact' or 'approx', got {selector!r}")
    descending = metric in DESCENDING_METRICS
    split = _Split(gallery, mesh, axis)
    v, m, sc = split.rows(valid), split.rows(mags), split.rows(scales)
    kk = min(k, split.nlocal)
    parts = []
    for s, _ in split.each():
        scores = _masked_shard_scores(split.queries(queries, s), split.gallery[s], v[s], m[s],
                                      sc[s], metric, weights, descending)
        vals, idx = exact_topk_wide(scores, kk, descending)
        parts.append((vals, split.offset(idx, s)))
    return _merge(parts, split, k, descending)


def multislice_search_topk(queries: torch.Tensor, gallery, valid, mags, k: int,
                           metric: str = "cosine_similarity",
                           weights: Optional[Tuple[float, ...]] = None,
                           scales=None, shadow=None, *, mesh: Mesh,
                           slice_axis: str = "slice",
                           data_axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """``sharded_search_topk`` over a gallery row-sharded across a (slice,
    data) mesh, slice-major (global row = (slice * n_data + data) *
    rows_per_shard + local row), with the hierarchical merge: each slice
    merges its shards' k-lists, then the slices merge theirs, so k
    candidates a slice cross between slices instead of k a device. The
    answers are the flat merge's."""
    return sharded_search_topk(queries, gallery, valid, mags, k, metric, weights, scales,
                               shadow, mesh=mesh, axis=(slice_axis, data_axis))


def sharded_multimetric_topk(queries: torch.Tensor, gallery, valid, mags, k: int,
                             scales=None, *, mesh: Optional[Mesh] = None,
                             axis: Axis = "data",
                             ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Per-metric exact top-k for all five metrics in one pass over each
    shard.

    Returns {metric: (values (Q, k'), indices (Q, k'))} for
    cosine_similarity (descending) and the l1/l2/linf/magnitude distances
    (ascending, +inf where `valid` is False), L2 from the explicit
    differences. A shard's planes are fused_all_metrics (the kernel on the
    card): over its whole block for f32 rows, over ROW_BLOCK rows upcast
    (bf16) or dequantized (int8 x scale) at a time otherwise."""
    split = _Split(gallery, mesh, axis)
    v, m, sc = split.rows(valid), split.rows(mags), split.rows(scales)
    kk = min(k, split.nlocal)
    parts: Dict[str, list] = {name: [] for name in PLANES}
    for s, dev in split.each():
        q = split.queries(queries, s).to(torch.float32)
        g, n = split.gallery[s], split.nlocal
        if g.dtype == torch.float32 and sc[s] is None:
            planes = fused_all_metrics(q, g, m[s])
        else:
            planes = torch.empty((len(PLANES), q.shape[0], n), dtype=torch.float32, device=dev)
            for lo in range(0, n, ROW_BLOCK):
                hi = min(lo + ROW_BLOCK, n)
                rows = g[lo:hi].to(torch.float32)
                if sc[s] is not None:
                    rows = rows * sc[s][lo:hi, None]
                planes[:, :, lo:hi] = fused_all_metrics(q, rows, m[s][lo:hi])
        for plane, name in zip(planes, PLANES):
            descending = name in DESCENDING_METRICS
            plane.masked_fill_(~v[s], float("-inf") if descending else float("inf"))
            vals, idx = exact_topk_wide(plane, kk, descending)
            parts[name].append((vals, split.offset(idx, s)))
    return {name: _merge(parts[name], split, k, name in DESCENDING_METRICS)
            for name in PLANES}


def sharded_scores(queries: torch.Tensor, gallery, mags, metric: str,
                   weights: Optional[Tuple[float, ...]] = None, scales=None, *,
                   mesh: Optional[Mesh] = None, axis: Axis = "data") -> torch.Tensor:
    """Full (Q, N) score matrix, for analysis-scale galleries: each shard's
    (Q, N / shards) plane, concatenated in shard order on the first shard's
    device. int8 rows are dequantized to f32 and scored by the f32
    functions (not the int8 fast paths sharded_search_topk takes: the two
    differ at the int8/bf16 rounding level, ~1e-3, by design)."""
    split = _Split(gallery, mesh, axis)
    m, sc = split.rows(mags), split.rows(scales)
    planes = []
    for s, _ in split.each():
        planes.append(_generic_scores(split.queries(queries, s).to(torch.float32),
                                      split.gallery[s], m[s], sc[s], metric, weights))
    dst = split.devices[0]
    return planes[0] if len(planes) == 1 else torch.cat([p.to(dst) for p in planes], -1)


def sharded_int4_screen_topk(queries: torch.Tensor, packed, valid, scales, c: int, *,
                             mesh: Optional[Mesh] = None,
                             axis: Axis = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine screen over the nibble-packed row-sharded gallery: each shard
    takes the top-min(c, rows per shard) of its int4 approximate scores (K3
    on the card), then the merge keeps c. Queries are normalized with the
    zero-norm guard and cast to bf16. Rows where `valid` is False score
    -inf and surface only as padding. Returns (scores (Q, c') f32, global
    row indices (Q, c') int64) on the first shard's device."""
    split = _Split(packed, mesh, axis)
    v, sc = split.rows(valid), split.rows(scales)
    cc = min(c, split.nlocal)
    parts = []
    for s, _ in split.each():
        qu = unit_queries(split.queries(queries, s)).to(torch.bfloat16)
        vals, idx = int4_screen_topc(qu, split.gallery[s], sc[s], v[s], cc,
                                     qform=INT4_SCREEN_QFORM)
        parts.append((vals, split.offset(idx, s)))
    return _merge(parts, split, c, True)


def sharded_int4_two_phase_topk(queries: torch.Tensor, packed, valid, scales, rows8,
                                scales8, c: int, k: int, *, mesh: Optional[Mesh] = None,
                                axis: Axis = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """int4 two-phase search with the int8 rows on the devices
    (IndexConfig.rerank_device): each shard screens its top-cc (K3), gathers
    its candidates' int8 rows, reranks them exactly (bf16-rounded unit
    query x int8 rows, f32 sums, x the int8 scale; screen padding -inf) and
    keeps its top-kk, the lowest candidate position first among ties; the
    merge keeps k of the exact lists. The candidate pool is c a shard.
    Returns (scores (Q, k') f32, global row indices (Q, k') int64)."""
    split = _Split(packed, mesh, axis)
    v, sc, g8, s8 = (split.rows(x) for x in (valid, scales, rows8, scales8))
    cc = min(c, split.nlocal)
    kk = min(k, cc)
    parts = []
    for s, _ in split.each():
        qu = unit_queries(split.queries(queries, s)).to(torch.bfloat16)
        sv, sidx = int4_screen_topc(qu, split.gallery[s], sc[s], v[s], cc,
                                    qform=INT4_SCREEN_QFORM)
        cand = g8[s][sidx].to(torch.float32)  # (Q, cc, D)
        ex = torch.bmm(cand, qu.to(torch.float32)[:, :, None])[..., 0] * s8[s][sidx]
        ex = torch.where(torch.isfinite(sv), ex, float("-inf"))
        vals, pos = exact_topk(ex, kk)
        parts.append((vals, split.offset(torch.gather(sidx, 1, pos), s)))
    return _merge(parts, split, k, True)
