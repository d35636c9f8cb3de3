"""The fused metric kernels (K4, K5, K6, K7) and their plain PyTorch versions.

Port of ``image_retrieval_tpu/ops/pallas_kernels.py`` l.1-578, under the JAX
package's names (the int4 screen of that file is ``ops/int4_screen.py``):

  fused_all_metrics (K6, ``_fused_kernel`` l.45)
      the five metric planes ``PLANES`` of every (query, row) pair in one
      read of the gallery, L2 from the explicit differences;
  fused_optimized_scores (K7, ``_combo_kernel`` l.124)
      the weighted similarity with weights read at run time (a (5,) tensor;
      no term is ever skipped), L2 in the Gram form;
  fused_optimized_topk (K4, ``_make_combo_topk_kernel`` l.399)
      the weighted similarity with static weights (zero weights drop their
      terms) and the top-k selection inside the kernel: the (Q, N) score
      plane never reaches device memory;
  fused_optimized_scores_int8_pallas, fused_optimized_scores_int8_pallas_v2
      (K5, ``_make_int8_combo_kernel`` l.162 and ``..._v2`` l.275)
      the weighted similarity over int8 rows in one read. The two JAX bodies
      share one contract and differ in how they schedule the TPU's vector
      unit, so here they are two names of one kernel. It has a sweep of its
      own (csrc/int8_sweep_sm90.cuh): persistent blocks stream the rows once
      for all queries through a TMA ring, the products and the L1 sum run on
      the tensor cores and the differences in packed bf16; ``int8_sweep_plan``
      is its launch plan.

Rows are (unit vector, magnitude) pairs, queries unnormalized; a metric
compares the query with ``row * magnitude``. The JAX entries' ``block_n`` is
the TPU kernels' VMEM tile and has no counterpart here.

Each entry launches the hand-written Hopper kernel (csrc/fused_metrics.cu)
for CUDA tensors and runs its ``*_reference`` for CPU tensors; it never falls
back from the card to the plain version. ``<entry>.launches`` counts kernel
launches.

Kernel against plain version: both compute every product and difference
with the same roundings, and the epilogue repeats the plain version's
operations in its order, so only the order of the f32 sums over D (for K5
also the tensor cores' f32 sums inside one 128-dim box) separates them:
``score_limit`` / ``scores_agree`` / ``topk_agree`` state what that allows,
and tests/test_torch_fused_metrics.py shows that the limits reject a
dropped magnitude, an L2 without its 1/sqrt(D), an int8 difference left in
f32 and ties broken towards the higher row.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from image_retrieval_tpu_torch.ops import metrics as M
from image_retrieval_tpu_torch.ops.topk import exact_topk_wide, two_key_topk

# Metric plane order of fused_all_metrics' stacked output.
PLANES = ("cosine_similarity", "l1_distance", "l2_distance", "linf_distance",
          "magnitude_difference")

# Blocks the top-k kernel is spread over: each walks a contiguous share of
# the tiles and emits one candidate list per query, so 4 blocks for each of
# an H100's 132 SMs leave 528 x k candidates per query to merge.
TOPK_BLOCKS = 528

# ---- what separates a kernel from its plain version -------------------------
# A sum over D = 512..768 f32 terms taken in another order moves by about
# sqrt(D) * 2^-24 of its size, ~1.5e-6 relative at worst in practice; the
# cosine's product is bounded by ||q|| and is divided by it, so it moves by
# ~1e-7 absolute. Linf, |dmag| and every rounding of K5 are the same
# operations on both sides and agree bit for bit.
SCORE_ATOL = 3e-6
SCORE_RTOL = 3e-6
# The Gram-form L2 takes sqrt of sq = m^2 - 2 m <g, q> + ||q||^2. Where a
# row equals the query, sq is a difference of numbers near m^2, and a
# product <g, q> that moved by GRAM_SQ_RTOL of its bound moves sq by
# delta = GRAM_SQ_RTOL * (m^2 + ||q||^2): sqrt(delta) after the root
# (~1e-3 * m), but only delta / (2 sqrt(sq)) away from the cancellation.
GRAM_SQ_RTOL = 1e-6


def gram_l2_slack(sq: torch.Tensor, magnitudes: torch.Tensor,
                  qn: torch.Tensor, d: int) -> torch.Tensor:
    """How far the Gram-form L2 / sqrt(d) can move when sq (Q, N) moves by
    GRAM_SQ_RTOL * (m^2 + ||q||^2): wide where sq is near 0 (a row equal
    to the query), negligible elsewhere. magnitudes (N,), qn (Q, 1)."""
    delta = GRAM_SQ_RTOL * (magnitudes[None, :] ** 2 + qn ** 2)
    return (torch.sqrt(sq + delta) - torch.sqrt(torch.clamp(sq - delta, min=0.0))) / d ** 0.5


def score_limit(want: torch.Tensor, w_l2: float = 0.0,
                l2_slack: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-element limit of |kernel - plain| for scores or planes `want`;
    `l2_slack` (gram_l2_slack) widens it by |w_l2| x slack where the score
    holds a Gram-form L2 term."""
    lim = SCORE_ATOL + SCORE_RTOL * want.abs()
    if l2_slack is not None and w_l2 != 0.0:
        lim = lim + abs(float(w_l2)) * l2_slack
    return lim


def scores_agree(got: torch.Tensor, want: torch.Tensor, limit) -> dict:
    """{"ok", "max_abs_err", "worst_ratio"}: ok when every |got - want| is
    within `limit` (a tensor like `want`, or a number) and both are finite
    in the same places."""
    err = (got.double() - want.double()).abs()
    fin = torch.isfinite(want)
    same = bool(torch.equal(torch.isfinite(got), fin))
    if not same or not bool(fin.any()):
        return {"ok": same and got.shape == want.shape, "max_abs_err": float("nan"),
                "worst_ratio": float("inf") if not same else 0.0}
    limit = torch.as_tensor(limit, dtype=torch.float64, device=want.device).expand_as(err)
    ratio = float((err[fin] / limit[fin]).max())
    return {"ok": ratio <= 1.0, "max_abs_err": float(err[fin].max()), "worst_ratio": ratio}


def topk_agree(got_v: torch.Tensor, got_i: torch.Tensor, want_v: torch.Tensor,
               want_i: torch.Tensor, plain_scores: torch.Tensor, limit) -> dict:
    """A top-k (values, indices) against the plain version's, given the
    plain (Q, N) scores and their per-element limit.

    Each returned value is within the limit of the plain score of the row
    it names; that row's plain score is within the limit of the plain
    version's value at the same rank (the same row, or a near tie: two
    rows whose plain scores tie may differ in the kernel's sums, and the
    other way round); and equal returned values come in ascending row
    order, which a kernel that breaks its ties towards the higher row
    does not give. Returns {"ok", "max_abs_err", "swaps", "why"}."""
    gi = got_i.to(torch.int64)
    if got_v.shape != want_v.shape or gi.shape != want_i.shape:
        return {"ok": False, "max_abs_err": float("nan"), "swaps": 0,
                "why": f"shape {tuple(got_v.shape)} != {tuple(want_v.shape)}"}
    if bool(((gi < 0) | (gi >= plain_scores.shape[1])).any()):
        return {"ok": False, "max_abs_err": float("nan"), "swaps": 0,
                "why": "an index outside the gallery"}
    limit = torch.as_tensor(limit, dtype=torch.float32,
                            device=plain_scores.device).expand_as(plain_scores)
    at = torch.gather(plain_scores, 1, gi)
    lim = torch.gather(limit, 1, gi)
    err = (got_v - at).abs()
    differs = gi != want_i.to(torch.int64)
    why = None
    if bool((err > lim).any()):
        why = "a value is outside the limit of its row's plain score"
    elif bool(((at - want_v).abs() > lim).any()):
        why = "a row ranks where the plain version has a score further than the limit"
    elif bool(((got_v[:, 1:] == got_v[:, :-1]) & (gi[:, 1:] < gi[:, :-1])).any()):
        why = "equal values not in ascending row order"
    return {"ok": why is None, "max_abs_err": float(err.max()) if err.numel() else 0.0,
            "swaps": int(differs.sum()), "why": why}


# ---- argument checks --------------------------------------------------------

def _check(name, queries, rows, magnitudes, row_dtypes, scales=None):
    if queries.dim() != 2 or rows.dim() != 2 or queries.shape[1] != rows.shape[1]:
        raise ValueError(f"{name}: queries (Q, D) and rows (N, D), got "
                         f"{tuple(queries.shape)} and {tuple(rows.shape)}")
    if rows.dtype not in row_dtypes:
        raise TypeError(f"{name}: rows must be one of {row_dtypes}, got {rows.dtype}")
    n = rows.shape[0]
    for what, a in (("magnitudes", magnitudes), ("scales", scales)):
        if a is not None and a.shape != (n,):
            raise ValueError(f"{name}: {what} {tuple(a.shape)} must be ({n},)")
    for what, a in (("rows", rows), ("magnitudes", magnitudes), ("scales", scales)):
        if a is not None and a.device != queries.device:
            raise ValueError(f"{name}: {what} on {a.device}, queries on {queries.device}")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {queries.device}")


def _static_weights(weights) -> Tuple[float, ...]:
    w = tuple(float(x) for x in weights)
    if len(w) != 5:
        raise ValueError(f"weights must be (w_angle, w_l1, w_l2, w_inf, w_mag), got {w}")
    return w


def _live_bits(w: Sequence[float]) -> int:
    return sum(1 << t for t, x in enumerate(w) if x != 0.0)


def _contiguous(*tensors):
    return [t.contiguous() for t in tensors]


def _launch(name, fn, device, *args):
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: " + lib.irt_error_string(rc).decode())


# ---- K6 ---------------------------------------------------------------------

def fused_all_metrics_reference(queries: torch.Tensor, gallery_unit: torch.Tensor,
                                magnitudes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of fused_all_metrics: the arithmetic of the
    index's multi-metric sweep (cosine through ||q|| only, differences
    against row * magnitude, direct L2), in row blocks. (5, Q, N) f32."""
    q, m = M._f32(queries), M._f32(magnitudes)
    d = M._dim_f32(q)
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    n = gallery_unit.shape[0]
    out = torch.empty((5, q.shape[0], n), dtype=torch.float32, device=q.device)
    for lo, hi in M.row_blocks(n, q.shape[0], q.shape[1]):
        g, mb = M._f32(gallery_unit[lo:hi]), m[lo:hi]
        out[0, :, lo:hi] = M._safe_div(q @ g.t(), qn)
        diff = (g * mb[:, None])[None, :, :] - q[:, None, :]
        ad = torch.abs(diff)
        out[1, :, lo:hi] = ad.sum(-1) / d
        out[2, :, lo:hi] = torch.sqrt((diff * diff).sum(-1)) / torch.sqrt(d)
        out[3, :, lo:hi] = ad.amax(-1)
        out[4, :, lo:hi] = torch.abs(mb[None, :] - qn)
    return out


def fused_all_metrics(queries: torch.Tensor, gallery_unit: torch.Tensor,
                      magnitudes: torch.Tensor) -> torch.Tensor:
    """All five metric planes in one gallery pass.

    queries (Q, D) f32, unnormalized; gallery_unit (N, D) f32 unit rows;
    magnitudes (N,) f32. Returns (5, Q, N) f32 ordered as PLANES; a
    zero-norm query has cosine 0."""
    _check("fused_all_metrics", queries, gallery_unit, magnitudes, (torch.float32,))
    if queries.device.type == "cpu":
        return fused_all_metrics_reference(queries, gallery_unit, magnitudes)
    q, g, m = _contiguous(M._f32(queries), gallery_unit, M._f32(magnitudes))
    qn = torch.linalg.vector_norm(q, dim=1)
    out = torch.empty((5, q.shape[0], g.shape[0]), dtype=torch.float32, device=q.device)
    if out.numel():
        _launch("fused_all_metrics", "irt_fused_all_metrics", q.device,
                q.data_ptr(), qn.data_ptr(), g.data_ptr(), m.data_ptr(), out.data_ptr(),
                q.shape[0], g.shape[0], q.shape[1])
        fused_all_metrics.launches += 1
    return out


fused_all_metrics.launches = 0


# ---- K7 ---------------------------------------------------------------------

def _weights_tensor(weights, device) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32, device=device).reshape(-1)
    if w.shape != (5,):
        raise ValueError(f"weights must hold 5 values, got {tuple(w.shape)}")
    return w.contiguous()


def fused_optimized_scores_reference(queries: torch.Tensor, gallery_unit: torch.Tensor,
                                     magnitudes: torch.Tensor, weights) -> torch.Tensor:
    """Plain PyTorch version of fused_optimized_scores: the f32 scorer with
    the Gram-form L2 and every weight a tensor, so no term is skipped."""
    w = _weights_tensor(weights, queries.device)
    return M.fused_optimized_scores_xla(queries, gallery_unit, magnitudes,
                                        tuple(w.unbind()), exact_l2=False)


def fused_optimized_scores(queries: torch.Tensor, gallery_unit: torch.Tensor,
                           magnitudes: torch.Tensor, weights) -> torch.Tensor:
    """(Q, N) weighted optimized-similarity in one gallery pass.

    weights: (5,) = (w_angle, w_l1, w_l2, w_inf, w_mag), a tensor (read by
    the kernel when it runs: one build serves every weight set) or a
    sequence. queries (Q, D) and gallery_unit (N, D) f32, magnitudes (N,)."""
    _check("fused_optimized_scores", queries, gallery_unit, magnitudes, (torch.float32,))
    if queries.device.type == "cpu":
        return fused_optimized_scores_reference(queries, gallery_unit, magnitudes, weights)
    q, g, m = _contiguous(M._f32(queries), gallery_unit, M._f32(magnitudes))
    w = _weights_tensor(weights, q.device)
    qn = torch.linalg.vector_norm(q, dim=1)
    out = torch.empty((q.shape[0], g.shape[0]), dtype=torch.float32, device=q.device)
    if out.numel():
        _launch("fused_optimized_scores", "irt_fused_optimized_scores", q.device,
                q.data_ptr(), qn.data_ptr(), w.data_ptr(), g.data_ptr(), m.data_ptr(),
                out.data_ptr(), q.shape[0], g.shape[0], q.shape[1])
        fused_optimized_scores.launches += 1
    return out


fused_optimized_scores.launches = 0


# ---- K5 ---------------------------------------------------------------------

# K5's sweep (csrc/int8_sweep_sm90.cuh): eight consumer warps and a producer
# warp a block, one block an SM; a warp's unit is 32 rows; stages are
# 128-dim boxes; at most 16 of them; dynamic shared memory up to 227 KB less
# 1 KB for the barriers, the ring aligned to 1 KB.
SWEEP_WARPS, SWEEP_UNIT_ROWS, SWEEP_BOX_DIMS, SWEEP_MAX_STAGES = 8, 32, 128, 16
SWEEP_ALIGN, SWEEP_SMEM_MAX = 1024, 232448 - 1024
H100_SMS = 132


@dataclass(frozen=True)
class Int8SweepPlan:
    """K5's launch plan: the fields of the C side's Int8SweepPlan, in its order."""
    qw: int           # queries of a warp's unit: 8, 16 or 32 (int8_sweep_plan)
    groups: int       # query groups of one pass (1, 2, 4 or 8)
    tile_rows: int    # rows of a tile: 32 * 8 / groups
    passes: int       # ceil(nq / (groups * qw))
    resident: int     # 1: every pass's queries in shared memory at once; 0: one pass's
    q_rows: int       # query rows in shared memory
    q_pitch: int      # bf16 elements from one query row to the next
    boxes: int        # 128-dim boxes of a row
    stages: int       # ring depth
    stage_bytes: int  # tile_rows * 128
    tma: int          # 1: TMA loads; 0: the producer warp copies
    tiles: int        # ceil(n / tile_rows)
    grid: int         # persistent blocks: min(tiles, SMs)
    smem: int         # dynamic shared memory of a block, bytes

    def block_tiles(self, block: int) -> range:
        """The row tiles block `block` walks: block, block + grid, ..."""
        return range(block, self.tiles, self.grid)


def int8_sweep_plan(nq: int, n: int, d: int, weights, aligned: bool = True,
                    sms: int = H100_SMS) -> Int8SweepPlan:
    """How K5 sweeps nq queries against n int8 rows of d values under the
    static `weights` (zeros dead) on a card of `sms` SMs; `aligned`: the rows'
    base is 16-byte aligned. A warp's unit is 32 rows and 8 queries where L1
    or Linf is live, 32 where only the product is (16 if 32 do not fit),
    else 16. A pass holds as many query groups as the queries need
    (a power of two, at most one per consumer warp); the tile's rows are the
    row units of the warps a group leaves. All queries (rounded up to 8) stay
    in shared memory where they fit beside two stages, else one pass's
    (reloaded before each pass), else fewer groups a pass; the ring takes the
    rest, beside the epilogue's scratch (sweep_epilogue_bytes). TMA loads
    where d % 16 == 0 and the base is aligned, else the producer warp
    copies. Raises ValueError for a shape the kernel does not take."""
    return _sweep_plan(nq, n, d, _live_bits(_static_weights(weights)), bool(aligned), sms)


@functools.lru_cache(maxsize=256)
def _sweep_plan(nq: int, n: int, d: int, live: int, aligned: bool, sms: int) -> Int8SweepPlan:
    if nq < 1 or n < 1 or d < 1 or sms < 1:
        raise ValueError(f"K5 needs at least one query, row, dim and SM: nq={nq}, n={n}, "
                         f"d={d}, sms={sms}")
    dot_only = bool(live & (1 | 4)) and not live & (2 | 8)
    qw = 8 if live & (2 | 8) else 32 if dot_only else 16
    plan = _sweep_plan_as(qw, nq, n, d, aligned, sms)
    if plan is None and qw == 32:
        plan = _sweep_plan_as(16, nq, n, d, aligned, sms)
    if plan is None:
        unit = 8 if qw == 8 else 16
        raise ValueError(f"K5 cannot take d = {d}: {unit} query rows of "
                         f"{2 * (-(-d // SWEEP_BOX_DIMS) * SWEEP_BOX_DIMS + 16)} bytes and two "
                         f"stages exceed {SWEEP_SMEM_MAX} bytes of shared memory")
    return plan


def sweep_epilogue_bytes(qw: int) -> int:
    """The epilogue's scratch: per consumer warp 32 rows of qw + 1 floats for
    the product, and for the L1 sum and the Linf max with 8-query units."""
    return SWEEP_WARPS * SWEEP_UNIT_ROWS * (qw + 1) * 4 * (3 if qw == 8 else 1)


def _sweep_plan_as(qw: int, nq: int, n: int, d: int, aligned: bool,
                   sms: int) -> Optional[Int8SweepPlan]:
    boxes = -(-d // SWEEP_BOX_DIMS)
    q_pitch = boxes * SWEEP_BOX_DIMS + 16
    q_row_bytes = 2 * q_pitch + 4  # the bf16 row and its norm
    epi = sweep_epilogue_bytes(qw)
    all_q = -(-nq // 8) * 8
    groups = 1
    while groups < SWEEP_WARPS and groups * qw < nq:
        groups *= 2
    while True:
        tile_rows = SWEEP_UNIT_ROWS * (SWEEP_WARPS // groups)
        stage = tile_rows * SWEEP_BOX_DIMS
        pass_q = groups * qw
        room = SWEEP_SMEM_MAX - SWEEP_ALIGN - epi - 2 * stage
        if all_q * q_row_bytes <= room:
            resident, q_rows = 1, all_q
        elif pass_q * q_row_bytes <= room:
            resident, q_rows = 0, pass_q
        elif groups > 1:
            groups //= 2
            continue
        else:
            return None
        break
    q_bytes = q_rows * q_row_bytes
    stages = min(SWEEP_MAX_STAGES, (SWEEP_SMEM_MAX - SWEEP_ALIGN - q_bytes - epi) // stage)
    tiles = -(-n // tile_rows)
    return Int8SweepPlan(qw, groups, tile_rows, -(-nq // pass_q), resident, q_rows, q_pitch,
                         boxes, stages, stage, int(aligned and d % 16 == 0), tiles,
                         min(tiles, sms), SWEEP_ALIGN + stages * stage + q_bytes + epi)


def fused_optimized_scores_int8_reference(queries: torch.Tensor, gallery_int8: torch.Tensor,
                                          scales: torch.Tensor, magnitudes: torch.Tensor,
                                          weights) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel: ops/metrics.py's
    fused_optimized_scores_int8 with static weights."""
    return M.fused_optimized_scores_int8(queries, gallery_int8, scales, magnitudes,
                                         _static_weights(weights))


def fused_optimized_scores_int8_pallas(queries: torch.Tensor, gallery_int8: torch.Tensor,
                                       scales: torch.Tensor, magnitudes: torch.Tensor,
                                       weights) -> torch.Tensor:
    """(Q, N) weighted optimized-similarity over an int8 gallery in one read
    of its rows, with the int8 scorer's arithmetic (bf16 query, exact
    products, f32 sums, bf16 L1/Linf differences).

    queries (Q, D) f32; gallery_int8 (N, D) int8; scales (N,) f32
    norm-preserving; magnitudes (N,) f32; weights a static 5-sequence of
    numbers, whose zeros drop their terms (with L1 and Linf dead no
    difference is formed). ``fused_optimized_scores_int8_pallas_v2`` is
    the same function: the JAX package's two bodies have one contract."""
    name = "fused_optimized_scores_int8_pallas"
    _check(name, queries, gallery_int8, magnitudes, (torch.int8,), scales)
    w = _static_weights(weights)
    if queries.device.type == "cpu":
        return fused_optimized_scores_int8_reference(queries, gallery_int8, scales,
                                                     magnitudes, w)
    q, g, sc, m = _contiguous(M._f32(queries), gallery_int8, M._f32(scales),
                              M._f32(magnitudes))
    qn = torch.linalg.vector_norm(q, dim=1)
    out = torch.empty((q.shape[0], g.shape[0]), dtype=torch.float32, device=q.device)
    if out.numel():
        int8_sweep_plan(q.shape[0], g.shape[0], q.shape[1], w,  # raises for a refused shape
                        g.data_ptr() % 16 == 0,
                        torch.cuda.get_device_properties(q.device).multi_processor_count)
        _launch(name, "irt_fused_optimized_scores_int8", q.device,
                q.data_ptr(), qn.data_ptr(), g.data_ptr(), sc.data_ptr(), m.data_ptr(),
                out.data_ptr(), q.shape[0], g.shape[0], q.shape[1], *w, _live_bits(w))
        fused_optimized_scores_int8_pallas.launches += 1
    return out


fused_optimized_scores_int8_pallas.launches = 0
fused_optimized_scores_int8_pallas_v2 = fused_optimized_scores_int8_pallas


# ---- K4 ---------------------------------------------------------------------

def fused_optimized_topk_reference(queries: torch.Tensor, gallery_unit: torch.Tensor,
                                   magnitudes: torch.Tensor, weights,
                                   k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of fused_optimized_topk: the f32 scorer with
    the Gram-form L2 and static weights (zeros drop their terms), then the
    exact top-k with lowest-row ties."""
    s = M.fused_optimized_scores_xla(queries, gallery_unit, magnitudes,
                                     _static_weights(weights), exact_l2=False)
    vals, idx = exact_topk_wide(s, min(k, s.shape[1]))
    return vals, idx.to(torch.int32)


def fused_optimized_topk(queries: torch.Tensor, gallery_unit: torch.Tensor,
                         magnitudes: torch.Tensor, weights,
                         k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact weighted-similarity top-k without materializing (Q, N) scores.

    weights: a static 5-sequence of numbers; zeros drop their terms.
    gallery_unit (N, D) f32 or bf16 (half the bytes; the arithmetic is f32).
    Returns (values (Q, kk) f32, indices (Q, kk) int32), kk = min(k, N),
    best first, equal scores by ascending row: what scoring and an exact
    top-k give. A row whose score is -inf (an infinite magnitude) is a
    candidate like any other: with fewer than kk finite scores the lowest
    such rows fill the answer, and every index is a row of the gallery.
    On the card k is at most the kernel's limit (64), and a NaN score
    ranks as -inf there (the plain version ranks it first); the inputs
    are expected to be finite."""
    name = "fused_optimized_topk"
    _check(name, queries, gallery_unit, magnitudes, (torch.float32, torch.bfloat16))
    w = _static_weights(weights)
    if k < 1:
        raise ValueError(f"{name}: k must be at least 1, got {k}")
    if queries.device.type == "cpu":
        return fused_optimized_topk_reference(queries, gallery_unit, magnitudes, w, k)
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    q, g, m = _contiguous(M._f32(queries), gallery_unit, M._f32(magnitudes))
    nq, n = q.shape[0], g.shape[0]
    kk = min(k, n)
    if kk > lib.irt_fused_metrics_max_k():
        raise ValueError(f"{name}: k = {kk} is above the kernel's limit of "
                         f"{lib.irt_fused_metrics_max_k()}")
    if nq == 0 or n == 0:
        return (torch.empty((nq, kk), dtype=torch.float32, device=q.device),
                torch.empty((nq, kk), dtype=torch.int32, device=q.device))
    ntiles = -(-n // lib.irt_fused_metrics_tile_rows())
    per_block = -(-ntiles // TOPK_BLOCKS)
    nblocks = -(-ntiles // per_block)
    qn = torch.linalg.vector_norm(q, dim=1)
    cand_v = torch.empty((nblocks, nq, kk), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((nblocks, nq, kk), dtype=torch.int32, device=q.device)
    _launch(name, "irt_fused_optimized_topk", q.device,
            q.data_ptr(), qn.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16),
            m.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(), nq, n, q.shape[1], kk,
            nblocks, *w, _live_bits(w))
    fused_optimized_topk.launches += 1
    # the blocks' candidates, merged under the canonical (score, row) order
    vals, idx = two_key_topk(cand_v.permute(1, 0, 2).reshape(nq, nblocks * kk),
                             cand_i.permute(1, 0, 2).reshape(nq, nblocks * kk), kk, True)
    return vals, idx.to(torch.int32)


fused_optimized_topk.launches = 0
