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
      plane never reaches device memory. K4, K6 and K7 run one sweep
      (csrc/f32_sweep_sm90.cuh): persistent blocks stream the rows once per
      pass of resident queries through a TMA ring, the products run on the
      tensor cores in split TF32 (K4's with the Gram-form L2 live on the CUDA
      cores, in the order of the sweep it replaced) and the differences in
      f32 on the CUDA cores; ``f32_sweep_plan`` is its launch plan;
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

Kernel against plain version: both compute every difference with the same
roundings, and the epilogue repeats the plain version's operations in its
order, so only the order of the f32 sums over D (and the tensor cores' f32
sums inside one box: for K5 exact products, for K4, K6 and K7 the split-TF32
products of ``split_tf32_dots``) separates them:
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

# ---- what separates a kernel from its plain version -------------------------
# A sum over D = 512..768 f32 terms taken in another order moves by about
# sqrt(D) * 2^-24 of its size, ~1.5e-6 relative at worst in practice; the
# cosine's product is bounded by ||q|| and is divided by it, so it moves by
# ~1e-7 absolute (the split-TF32 product of K4, K6 and K7 drops lo * lo, a
# term of 2^-22 of each product, and its tensor-core sums restart every box:
# ``split_tf32_dots`` models it). Linf, |dmag| and every rounding of K5 are
# the same operations on both sides and agree bit for bit.
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
        qpad = _padded_queries(_device_plan(q, g, None), q)
        _launch("fused_all_metrics", "irt_fused_all_metrics", q.device,
                q.data_ptr(), qn.data_ptr(), _ptr(qpad), g.data_ptr(), m.data_ptr(),
                out.data_ptr(), q.shape[0], g.shape[0], q.shape[1])
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
        qpad = _padded_queries(_device_plan(q, g, None), q)
        _launch("fused_optimized_scores", "irt_fused_optimized_scores", q.device,
                q.data_ptr(), qn.data_ptr(), _ptr(qpad), w.data_ptr(), g.data_ptr(),
                m.data_ptr(), out.data_ptr(), q.shape[0], g.shape[0], q.shape[1])
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


# ---- the sweep of K4, K6 and K7 ---------------------------------------------

# Their sweep (csrc/f32_sweep_sm90.cuh) runs in K5's block (SWEEP_WARPS
# consumer warps and a producer warp, one block an SM, dynamic shared memory
# up to SWEEP_SMEM_MAX, the ring aligned to SWEEP_ALIGN, at most
# SWEEP_MAX_STAGES stages); a warp's unit is 16 rows; a stage is 128 bytes of
# each row of a tile for each of a stage's boxes; K4 keeps per warp a top-kk
# list and a 17-float scratch
# for each query of its unit; k is at most 64.
F32_UNIT_ROWS, F32_BOX_BYTES, F32_KEEP, F32_MAX_K = 16, 128, 17, 64
F32_STAGE_TARGET = 8192  # bytes a stage aims at: several 128-byte boxes of a small tile


@dataclass(frozen=True)
class F32SweepPlan:
    """The launch plan of K4, K6 and K7: the fields of the C side's
    F32SweepPlan, in its order."""
    qw: int           # queries of a warp's unit: 8 or 32
    groups: int       # query groups of one pass (1, 2, 4 or 8)
    tile_rows: int    # rows of a tile: 16 * 8 / groups
    passes: int       # ceil(nq / (groups * qw)): the grid's second dimension
    resident: int     # 1: the pass's queries in shared memory; 0: read from a padded copy
    q_rows: int       # query rows in shared memory
    q_pitch: int      # f32 elements from one query row to the next
    box_dims: int     # values of a row in one stage: 32 (f32) or 64 (bf16)
    boxes: int        # ceil(d / box_dims)
    stage_boxes: int  # boxes of a tile one stage holds (about 8 KB, at most a row's)
    stages: int       # ring depth
    stage_bytes: int  # stage_boxes * tile_rows * 128
    tma: int          # 1: TMA loads; 0: the producer warp copies
    tiles: int        # ceil(n / tile_rows)
    grid: int         # blocks of a pass: min(tiles, max(1, SMs // passes))
    lists: int        # K4: candidate lists per query, grid * 8 / groups; else 0
    smem: int         # dynamic shared memory of a block, bytes

    def block_tiles(self, block: int) -> range:
        """The row tiles block `block` of a pass walks: block, block + grid, ..."""
        return range(block, self.tiles, self.grid)


def f32_topk_bytes(qw: int, kk: int) -> int:
    """K4's per-warp top-kk lists (score and row) and unit scratch, bytes."""
    return SWEEP_WARPS * qw * (kk * 8 + F32_KEEP * 4) if kk > 0 else 0


def f32_sweep_plan(nq: int, n: int, d: int, weights=None, row_bytes: int = 4, k: int = 0,
                   aligned: bool = True, sms: int = H100_SMS) -> F32SweepPlan:
    """How K4, K6 or K7 sweep nq queries against n rows of d values of
    `row_bytes` bytes (4: f32, 2: bf16) under `weights` (None: every term, as
    K6 and K7 take them; else the static weights of K4, zeros dead) with a
    top-k of k (K4; 0 for K6 and K7) on a card of `sms` SMs; `aligned`: the
    rows' base is 16-byte aligned. A warp's unit is 16 rows and 32 queries
    where the cosine's product is the only sum (8 where 32 do not fit
    beside their lists), else 8: L1 or Linf live, no product, or the
    Gram-form L2, whose product K4 takes on the CUDA cores. A pass holds as many query
    groups as the queries need (a power of two, at most one per consumer
    warp), the tile's rows the row units of the warps a group leaves; the
    passes are the grid's second dimension. A pass's queries stay in shared
    memory where they fit beside two stages (with fewer groups a pass if
    need be), else the kernel reads them from a zero-padded copy in device
    memory. TMA loads where d % 4 == 0 (f32) or d % 8 == 0 (bf16) and the
    base is aligned, else the producer warp copies. Raises ValueError for a
    shape the kernels do not take: nq, n, d below 1, k above 64, or more
    than 65,535 passes."""
    live = 31 if weights is None else _live_bits(_static_weights(weights))
    return _f32_plan(nq, n, d, row_bytes, live, k, bool(aligned), sms)


@functools.lru_cache(maxsize=512)
def _f32_plan(nq: int, n: int, d: int, row_bytes: int, live: int, kk: int, aligned: bool,
              sms: int) -> F32SweepPlan:
    if (nq < 1 or n < 1 or d < 1 or sms < 1 or not 0 <= kk <= F32_MAX_K
            or row_bytes not in (2, 4)):
        raise ValueError(f"the f32 sweep needs at least one query, row, dim and SM, k <= "
                         f"{F32_MAX_K} and rows of 4 or 2 bytes: nq={nq}, n={n}, d={d}, "
                         f"k={kk}, row_bytes={row_bytes}, sms={sms}")
    dot_only = live & (1 | 2 | 4 | 8) == 1
    plan = _f32_plan_as(32, nq, n, d, row_bytes, kk, True, aligned, sms) if dot_only else None
    for resident in (True, False):
        plan = plan or _f32_plan_as(8, nq, n, d, row_bytes, kk, resident, aligned, sms)
    if plan.passes > 65535:
        raise ValueError(f"the f32 sweep takes at most 65,535 passes of queries: nq={nq}")
    return plan


def _f32_plan_as(qw: int, nq: int, n: int, d: int, row_bytes: int, kk: int, resident: bool,
                 aligned: bool, sms: int) -> Optional[F32SweepPlan]:
    box_dims = F32_BOX_BYTES // row_bytes
    boxes = -(-d // box_dims)
    q_pitch = boxes * box_dims + 4
    epi = f32_topk_bytes(qw, kk)
    all_q = -(-nq // 8) * 8
    groups = 1
    while groups < SWEEP_WARPS and groups * qw < nq:
        groups *= 2
    while True:
        box = F32_UNIT_ROWS * (SWEEP_WARPS // groups) * F32_BOX_BYTES
        q_rows = min(groups * qw, all_q) if resident else 0
        fixed = SWEEP_ALIGN + q_rows * q_pitch * 4 + epi
        if fixed + 2 * box <= SWEEP_SMEM_MAX:
            break
        if groups == 1:
            return None
        groups //= 2
    stage_boxes = max(1, min(F32_STAGE_TARGET // box, boxes))
    while stage_boxes > 1 and fixed + 2 * stage_boxes * box > SWEEP_SMEM_MAX:
        stage_boxes -= 1
    stage = stage_boxes * box
    stages = min(SWEEP_MAX_STAGES, (SWEEP_SMEM_MAX - fixed) // stage)
    tile_rows = F32_UNIT_ROWS * (SWEEP_WARPS // groups)
    passes = -(-nq // (groups * qw))
    tiles = -(-n // tile_rows)
    grid = min(tiles, max(1, sms // passes))
    return F32SweepPlan(qw, groups, tile_rows, passes, int(resident), q_rows, q_pitch, box_dims,
                        boxes, stage_boxes, stages, stage,
                        int(aligned and d % (16 // row_bytes) == 0), tiles,
                        grid, grid * (SWEEP_WARPS // groups) if kk else 0,
                        fixed + stages * stage)


def _device_plan(q: torch.Tensor, rows: torch.Tensor, weights, kk: int = 0) -> F32SweepPlan:
    """The plan the C side takes for this call on q's card."""
    return f32_sweep_plan(q.shape[0], rows.shape[0], q.shape[1], weights, rows.element_size(),
                          kk, rows.data_ptr() % 16 == 0,
                          torch.cuda.get_device_properties(q.device).multi_processor_count)


def _padded_queries(plan: F32SweepPlan, q: torch.Tensor) -> Optional[torch.Tensor]:
    """None where the plan keeps the queries in shared memory; else q
    zero-padded to (nq rounded up to 8, q_pitch), which the kernel reads."""
    if plan.resident:
        return None
    out = torch.zeros((-(-q.shape[0] // 8) * 8, plan.q_pitch), dtype=torch.float32,
                      device=q.device)
    out[: q.shape[0], : q.shape[1]] = q
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as cvt.rna.tf32.f32 rounds: half a TF32 unit added to
    the magnitude's bits, then the 13 low bits cleared."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_dots(queries: torch.Tensor, rows: torch.Tensor, box: int = 32,
                    products: int = 3) -> torch.Tensor:
    """(Q, N) <q, row> as the sweep of K4, K6 and K7 forms them on the
    tensor cores, in f32: every value split into hi = tf32_rna(x) and lo =
    tf32_rna(x - hi); per box of `box` dims the sum of the products
    q_lo * g_hi + q_hi * g_lo + q_hi * g_hi (products=3; products=1: hi * hi
    alone, one TF32 product); each box's sum added to the f32 total. The
    order of the sums inside a box is the f32 matmul's here, the tensor
    cores' there: a model of the split, not of its bits."""
    q, g = queries.to(torch.float32), rows.to(torch.float32)
    qh, gh = tf32_rna(q), tf32_rna(g)
    ql, gl = tf32_rna(q - qh), tf32_rna(g - gh)
    total = torch.zeros((q.shape[0], g.shape[0]), dtype=torch.float32, device=q.device)
    for lo in range(0, q.shape[1], box):
        s = slice(lo, lo + box)
        part = qh[:, s] @ gh[:, s].t()
        if products == 3:
            part = (ql[:, s] @ gh[:, s].t() + qh[:, s] @ gl[:, s].t()) + part
        total = total + part
    return total


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
    q, g, m = _contiguous(M._f32(queries), gallery_unit, M._f32(magnitudes))
    nq, n = q.shape[0], g.shape[0]
    kk = min(k, n)
    if kk > F32_MAX_K:
        raise ValueError(f"{name}: k = {kk} is above the kernel's limit of {F32_MAX_K}")
    if nq == 0 or n == 0:
        return (torch.empty((nq, kk), dtype=torch.float32, device=q.device),
                torch.empty((nq, kk), dtype=torch.int32, device=q.device))
    plan = _device_plan(q, g, w, kk)
    qn = torch.linalg.vector_norm(q, dim=1)
    qpad = _padded_queries(plan, q)
    cand_v = torch.empty((plan.lists, nq, kk), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((plan.lists, nq, kk), dtype=torch.int32, device=q.device)
    _launch(name, "irt_fused_optimized_topk", q.device,
            q.data_ptr(), qn.data_ptr(), _ptr(qpad), g.data_ptr(),
            int(g.dtype == torch.bfloat16), m.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(),
            nq, n, q.shape[1], kk, plan.lists, *w, _live_bits(w))
    fused_optimized_topk.launches += 1
    # the warps' candidate lists, merged under the canonical (score, row) order
    vals, idx = two_key_topk(cand_v.permute(1, 0, 2).reshape(nq, plan.lists * kk),
                             cand_i.permute(1, 0, 2).reshape(nq, plan.lists * kk), kk, True)
    return vals, idx.to(torch.int32)


fused_optimized_topk.launches = 0
