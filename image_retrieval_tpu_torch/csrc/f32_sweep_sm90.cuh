// The f32 metric sweep of K6, K7 and K4 (fused_metrics.cu: all_metrics,
// optimized_scores and optimized_topk) for Hopper (sm_90a): its launch plan,
// the per-box work of one consumer warp, the top-k merge and the kernel body
// the three share. Mirrored in Python by ops/fused_metrics.py::f32_sweep_plan.
//
// What bounds the three on this card. Per row the bytes (2 KB at D = 512 in
// f32), once; per (query, row, dim) the product (tensor-core work, three
// TF32 products over f32 rows, two over bf16 rows) and, where L1, Linf or
// K6's direct L2 take part, the f32 difference u - q and its sums on the
// CUDA cores: a subtract, then an add for L1, a max for Linf and an FMA for
// the direct L2, one slot each of the 33.5 T a second. At Q = 1 the bytes
// bound all three; from a few queries on, the differences bound K6, K7 and
// K4 with L1 or Linf live, and the tensor cores the cosine-only K4.
//
// The design (K5's sweep, int8_sweep_sm90.cuh, for f32 and bf16 rows):
//   - Persistent blocks, one an SM: block (b, pass) takes the row tiles b,
//     b + grid, ... in ascending order, for one pass of queries (grid.y
//     holds the passes). A tile is 16 * 8 / groups rows.
//   - A ring of stages in dynamic shared memory, each stage_boxes 128-byte
//     boxes of a tile's rows (a box: 32 f32 or 64 bf16 values, tile rows x
//     128 bytes under the 128-byte swizzle; a stage about 8 KB, several boxes
//     of a 16-row tile: stages of one box paid the handshake per 2 KB),
//     filled by one producer warp: TMA (zero fill past the last row and past
//     d) where the rows' stride and base allow it (d % 4 == 0 for f32, d % 8
//     == 0 for bf16, a 16-byte-aligned base); else its 32 lanes copy the
//     boxes themselves into the same layout. Eight consumer warps read every
//     stage and hand it back through its `empty` mbarrier.
//   - A pass's queries stay in shared memory as f32 rows (padded with zeros
//     to whole boxes, at a pitch of 16 mod 128 bytes) for all of the block's
//     tiles, so a row is read from device memory once per pass. Where even
//     one pass does not fit, the consumers read them from a zero-padded copy
//     the wrapper makes in device memory (`resident` 0), so every d is taken.
//   - A warp's unit is 16 rows (one m16 tile) x qw queries: 32 where the
//     cosine's product is the only sum, else 8. The pass's query
//     groups times the tile's row units give the 8 warps one unit each: at
//     Q = 1 every warp has 16 rows of its own.
//   - The product on the tensor cores, mma.sync m16n8k8 tf32, rows on M and
//     queries on N: each f32 value x split as hi = rna(x), lo = rna(x - hi)
//     (cvt.rna.tf32's rounding, in integer operations: tf32_rna), and
//     hi*lo + lo*hi + hi*hi accumulated (the small terms first); a bf16 row
//     is exact in tf32, so its two products are row*lo + row*hi. Lane (g, t)
//     takes the 16-byte chunks 2t and 2t + 1 of a box's row (conflict-free
//     under the swizzle), and a chunk's values 2h, 2h + 1 stand at k = t,
//     t + 4 of a k-step: a permutation of the dims, the same for A and B.
//     A query slice's k-steps run on four accumulators (two with 32-query
//     units, where registers are short), as many mma chains side by side:
//     on an H100 an mma's result comes ~28 clocks after its issue, and an SM
//     sub-partition issues one every ~7 (csrc/experiments/tf32_mma_rate.cu).
//     The mma sums restart every box and are added to f32 totals on the
//     CUDA cores.
//   - The differences on the CUDA cores in f32, in the plain version's
//     roundings: u = g * m once per row element (shared by the unit's
//     queries), u - q rounded, then |u - q| into the L1 sum (a per-box sum,
//     then the total), the Linf max and (K6) (u - q)^2 into the direct-L2
//     sum. Lane (g, t) sums rows g, g + 8 against all 8 queries over its
//     dims; the quad's four partial sums are combined at the end of a unit
//     (a reduce-scatter: lane t keeps queries 2t, 2t + 1, where the product's
//     C fragment has them). Only the order of the sums over d differs from
//     the plain version: Linf and |dmag| are its bits.
//   - K4 with the Gram-form L2 live takes the product on the CUDA cores
//     instead (kDot == 2, fs_box_seq), in the order of the CUDA-core sweep
//     this one replaced: per (row, query) the fmaf of every dim in ascending
//     order, each 64 dims' sum then added to the total. Its sq = m^2 -
//     2 m <g, q> + ||q||^2 cancels where a query equals a stored row (an
//     image looked up by itself), so the score there is set by the last bit
//     of the product: one ulp moves sqrt(sq) / sqrt(d) by ~1e-4. There the
//     split-TF32 product (the tensor cores' sums truncate) put K4 ~1e-4 from
//     the plain version at D = 64, where this order, like the old sweep,
//     stays within 1e-5 (tests/test_torch_gpu.py::
//     test_fused_topk_kernel_small_gallery_and_limits). Lane l takes row
//     l % 16 of the unit against queries 4 (l / 16) .. + 3, the L1 and Linf
//     sums with it.
//   - The epilogue per unit: K6 and K7 store from the fragments (32
//     contiguous bytes of a (Q, N) plane per query and row group); K4 parks
//     the unit's scores in a per-warp scratch and merges them, one query at a
//     time, into the warp's own top-kk list of that query: lane j first tests
//     whether any score of query j beats its kk-th kept one (the units of a
//     warp arrive in ascending row order, so an equal score ranks after it),
//     then only those queries are merged: the candidates that rank before
//     the kk-th kept entry are inserted one by one (fs_merge). While one warp
//     merges, the others sweep. Each warp's lists are candidate lists of
//     their own (lists = grid * row units), merged afterwards by the wrapper.
// csrc/experiments/f32_sweep_variants.py times this design beside the
// variants it was chosen over.
#pragma once

#include <limits.h>

#include "fused_metrics.cuh"
#include "gemm_sm90.cuh"
#include "int8_sweep_sm90.cuh"

namespace {

using namespace fm;

constexpr int kFsUnitRows = 16;  // rows of a warp's unit: one m16 tile
constexpr int kFsBoxBytes = 128;  // bytes of one stage's rows
constexpr int kFsKeep = 17;       // scratch floats per query of a K4 unit: 16 rows and a pad
constexpr int kFsStageTarget = 8192;  // bytes a stage aims at: the per-stage handshake amortized

// The launch plan of one call of K4, K6 or K7 (mirrored by
// ops/fused_metrics.py::f32_sweep_plan).
struct F32SweepPlan {
  int qw;           // queries of a warp's unit: 8 or 32
  int groups;       // query groups of one pass: 1, 2, 4 or 8
  int tile_rows;    // rows of a tile: 16 * 8 / groups
  int passes;       // ceil(nq / (groups * qw)), grid.y
  int resident;     // 1: the pass's queries in shared memory; 0: read from the padded copy
  int q_rows;       // query rows in shared memory: min(groups * qw, nq rounded up to 8)
  int q_pitch;      // f32 elements from one query row to the next: boxes * box_dims + 4
  int box_dims;     // values of a row in one box: 32 (f32) or 64 (bf16)
  int boxes;        // ceil(d / box_dims)
  int stage_boxes;  // boxes of a tile one stage holds (about 8 KB, at most a row's)
  int stages;       // ring depth
  int stage_bytes;  // stage_boxes * tile_rows * 128
  int tma;          // 1: TMA loads; 0: the producer warp copies
  int tiles;        // ceil(n / tile_rows)
  int grid;         // grid.x: min(tiles, max(1, SMs / passes))
  int lists;        // K4: candidate lists per query, grid * 8 / groups; 0 otherwise
  int smem;         // dynamic shared memory of a block, bytes
};

// K4's per-warp top-kk lists (value and row) and unit scratch, bytes.
inline long long fs_topk_bytes(int qw, int kk) {
  return kk > 0 ? (long long)kSwWarps * qw * (kk * 8LL + kFsKeep * 4) : 0;
}

inline bool f32_sweep_plan_as(int qw, int nq, int n, int d, int row_bytes, int kk, bool resident,
                              bool aligned, int sms, F32SweepPlan* p) {
  p->qw = qw;
  p->box_dims = kFsBoxBytes / row_bytes;
  p->boxes = sw_ceil(d, p->box_dims);
  p->q_pitch = p->boxes * p->box_dims + 4;
  const long long q_row_bytes = 4LL * p->q_pitch;
  const long long epi = fs_topk_bytes(qw, kk);
  const int all_q = (nq + 7) / 8 * 8;
  int groups = 1;
  while (groups < kSwWarps && (long long)groups * qw < nq) groups *= 2;
  for (;; groups /= 2) {
    const long long box = (long long)kFsUnitRows * (kSwWarps / groups) * kFsBoxBytes;
    const int q_rows = resident ? (groups * qw < all_q ? groups * qw : all_q) : 0;
    const long long fixed = kSwAlign + q_rows * q_row_bytes + epi;
    if (fixed + 2 * box <= kSwSmemMax) {
      p->groups = groups;
      p->q_rows = q_rows;
      int sb = (int)(kFsStageTarget / box);
      sb = sb < 1 ? 1 : sb > p->boxes ? p->boxes : sb;
      while (sb > 1 && fixed + 2 * sb * box > kSwSmemMax) --sb;
      const long long stage = sb * box;
      p->stage_boxes = sb;
      p->stage_bytes = (int)stage;
      p->stages = (int)((kSwSmemMax - fixed) / stage < kSwMaxStages ? (kSwSmemMax - fixed) / stage
                                                                    : kSwMaxStages);
      p->smem = (int)(fixed + (long long)p->stages * stage);
      break;
    }
    if (groups == 1) return false;
  }
  p->resident = resident ? 1 : 0;
  p->tile_rows = kFsUnitRows * (kSwWarps / p->groups);
  p->passes = sw_ceil(nq, (long long)p->groups * qw);
  p->tma = aligned && d % (16 / row_bytes) == 0;
  p->tiles = sw_ceil(n, p->tile_rows);
  const int per_pass = sms / p->passes > 1 ? sms / p->passes : 1;
  p->grid = p->tiles < per_pass ? p->tiles : per_pass;
  p->lists = kk > 0 ? p->grid * (kSwWarps / p->groups) : 0;
  return p->passes <= 65535;
}

// The plan for nq queries against n rows of d values of `row_bytes` bytes
// (4: f32, 2: bf16) under the live weight bits `live` (bit t: weight t), with
// kk > 0 for K4's top-kk lists; `aligned`: the rows' base is 16-byte aligned.
// Units of 32 queries where the cosine's product is the only sum (8 where 32
// do not fit beside their lists), else 8: L1 or Linf live, no product, or
// the Gram-form L2 (K4 takes its product on the CUDA cores). The queries stay resident where
// a pass of them fits beside two stages (fewer groups a pass, down to one,
// before giving up), else they are read from the wrapper's padded copy.
// False only for nq, n, d below 1, kk above 64, or more than 65,535 passes.
inline bool f32_sweep_plan(int nq, int n, int d, int row_bytes, int live, int kk, bool aligned,
                           int sms, F32SweepPlan* p) {
  if (nq < 1 || n < 1 || d < 1 || sms < 1 || kk < 0 || kk > kMaxK ||
      (row_bytes != 4 && row_bytes != 2)) {
    return false;
  }
  const bool dot_only = (live & (1 | 2 | 4 | 8)) == 1;
  if (dot_only && f32_sweep_plan_as(32, nq, n, d, row_bytes, kk, true, aligned, sms, p)) {
    return true;
  }
  return f32_sweep_plan_as(8, nq, n, d, row_bytes, kk, true, aligned, sms, p) ||
         f32_sweep_plan_as(8, nq, n, d, row_bytes, kk, false, aligned, sms, p);
}

// ---------------------------------------------------------------------------
// Rows, splits and products
// ---------------------------------------------------------------------------

// Values 4s .. 4s + 3 of a 16-byte chunk of a row as f32.
template <typename RowT>
struct FsRow;

template <>
struct FsRow<float> {
  static constexpr int kValues = 4;  // values of one chunk
  __device__ static __forceinline__ void quad(const uint4& c, int, float* x) {
    x[0] = __uint_as_float(c.x);
    x[1] = __uint_as_float(c.y);
    x[2] = __uint_as_float(c.z);
    x[3] = __uint_as_float(c.w);
  }
};

template <>
struct FsRow<__nv_bfloat16> {
  static constexpr int kValues = 8;
  __device__ static __forceinline__ void quad(const uint4& c, int s, float* x) {
    const uint32_t a = s ? c.z : c.x, b = s ? c.w : c.y;
    x[0] = __uint_as_float(a << 16);
    x[1] = __uint_as_float(a & 0xFFFF0000u);
    x[2] = __uint_as_float(b << 16);
    x[3] = __uint_as_float(b & 0xFFFF0000u);
  }
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; infinities and quiet NaNs kept): half a TF32 unit added to the
// magnitude's bits, then the 13 low bits cleared. Two integer operations at
// the full rate: the conversion instruction runs on a narrow pipe, and with
// it the splits, not the products, bounded the sweep.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + (what TF32 cannot hold of x - hi), hi and lo TF32 values.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// D = A(16x8 tf32, row) * B(8x8 tf32, col) + D, f32.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte chunk c of row r of a unit (its first row in the stage), under
// the 128-byte swizzle (a unit starts on a multiple of 8 rows).
__device__ __forceinline__ uint4 fs_chunk(const uint8_t* unit, int r, int c) {
  return *reinterpret_cast<const uint4*>(unit + r * kFsBoxBytes + ((c ^ (r & 7)) << 4));
}

// ---------------------------------------------------------------------------
// One box of one unit
// ---------------------------------------------------------------------------

// The unit's sums. dot: the C fragments (rows g, g + 8 x queries 8 nn + 2t,
// + 1). l1, linf, sq: lane (g, t)'s partial sums of rows g + 8 i against the
// unit's 8 queries over its dims (kQW == 8 only).
template <int kQW>
struct FsAcc {
  static constexpr int kD = kQW == 8 ? 8 : 1;
  float dot[kQW / 8][4];
  float l1[2][kD], linf[2][kD], sq[2][kD];
};

// One box (`qbox`: the unit's first query row at the box's first dim) of the
// unit's 16 rows against its first `live_q` of kQW queries. kFull: all kQW
// queries are live (nothing is skipped). m0, m1: the magnitudes of rows g
// and g + 8.
template <typename RowT, int kQW, bool kDot, bool kL1, bool kLinf, bool kSq, bool kFull>
__device__ __forceinline__ void fs_box(const uint8_t* unit, const float* qbox, int pitch,
                                       int live_q, int g, int t, float m0, float m1,
                                       FsAcc<kQW>& acc) {
  constexpr bool kDiff = kL1 || kLinf || kSq;
  constexpr int kE = FsRow<RowT>::kValues;
  constexpr bool kExact = sizeof(RowT) == 2;  // a bf16 row is a TF32 value: no lo part
  constexpr int kNG = kQW / 8;
  static_assert(!kDiff || kQW == 8, "the differences take 8-query units");
  // the box's products on kC accumulators a query slice (chunk parity p and
  // k-step parity h with 8-query units, h alone with 32), so that as many
  // mma chains run side by side
  constexpr int kC = kQW == 8 ? 4 : 2;
  float part[kC][kNG][4], l1p[2][8];
#pragma unroll
  for (int h = 0; h < kC; ++h) {
#pragma unroll
    for (int nn = 0; nn < kNG; ++nn) {
#pragma unroll
      for (int k = 0; k < 4; ++k) part[h][nn][k] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) l1p[i][j] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = 2 * t + p;
    const uint4 r0 = fs_chunk(unit, g, c), r1 = fs_chunk(unit, g + 8, c);
#pragma unroll 1
    for (int s = 0; s < kE / 4; ++s) {  // bf16: two halves of a chunk (unrolled, they spilled)
      float x0[4], x1[4];
      FsRow<RowT>::quad(r0, s, x0);
      FsRow<RowT>::quad(r1, s, x1);
      const float* qc = qbox + c * kE + 4 * s;
      if constexpr (kDot) {
        // two k-steps: values 2h, 2h + 1 at k = t, t + 4
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a[4] = {x0[2 * h], x1[2 * h], x0[2 * h + 1], x1[2 * h + 1]};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (kExact) {
              ahi[h][k] = __float_as_uint(a[k]);
            } else {
              tf32_split(a[k], ahi[h][k], alo[h][k]);
            }
          }
        }
#pragma unroll
        for (int nn = 0; nn < kNG; ++nn) {
          if (kFull || nn == 0 || 8 * nn < live_q) {
            const float4 qv = *reinterpret_cast<const float4*>(qc + (size_t)(8 * nn + g) * pitch);
            const float qe[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t bhi0, blo0, bhi1, blo1;
              tf32_split(qe[2 * h], bhi0, blo0);
              tf32_split(qe[2 * h + 1], bhi1, blo1);
              float* acc_c = part[kC == 4 ? 2 * p + h : h][nn];
              if (!kExact) mma_tf32(acc_c, alo[h], bhi0, bhi1);
              mma_tf32(acc_c, ahi[h], blo0, blo1);
              mma_tf32(acc_c, ahi[h], bhi0, bhi1);
            }
          }
        }
      }
      if constexpr (kDiff) {
        float u0[4], u1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          u0[e] = __fmul_rn(x0[e], m0);
          u1[e] = __fmul_rn(x1[e], m1);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kFull || j < live_q) {
            const float4 qv = *reinterpret_cast<const float4*>(qc + (size_t)j * pitch);
            const float qe[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float d0 = __fsub_rn(u0[e], qe[e]), d1 = __fsub_rn(u1[e], qe[e]);
              if (kL1) {
                l1p[0][j] += fabsf(d0);
                l1p[1][j] += fabsf(d1);
              }
              if (kLinf) {
                acc.linf[0][j] = fmaxf(acc.linf[0][j], fabsf(d0));
                acc.linf[1][j] = fmaxf(acc.linf[1][j], fabsf(d1));
              }
              if (kSq) {
                acc.sq[0][j] = fmaf(d0, d0, acc.sq[0][j]);
                acc.sq[1][j] = fmaf(d1, d1, acc.sq[1][j]);
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int nn = 0; nn < kNG; ++nn) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float sum = part[0][nn][k];
#pragma unroll
      for (int c = 1; c < kC; ++c) sum = __fadd_rn(sum, part[c][nn][k]);
      acc.dot[nn][k] += sum;
    }
  }
  if constexpr (kL1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.l1[i][j] += l1p[i][j];
    }
  }
}

// The quad's four partial sums (or maxima, kMax) of 8 queries, scattered:
// lane t ends with queries 2t and 2t + 1 in out[0], out[1].
template <bool kMax>
__device__ __forceinline__ void fs_quad_scatter(const float* v, int t, float* out) {
  float h[4];
  const bool hi2 = (t & 2) != 0, hi1 = (t & 1) != 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = hi2 ? v[j] : v[j + 4], keep = hi2 ? v[j + 4] : v[j];
    const float got = __shfl_xor_sync(0xffffffffu, send, 2);
    h[j] = kMax ? fmaxf(keep, got) : __fadd_rn(keep, got);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = hi1 ? h[j] : h[j + 2], keep = hi1 ? h[j + 2] : h[j];
    const float got = __shfl_xor_sync(0xffffffffu, send, 1);
    out[j] = kMax ? fmaxf(keep, got) : __fadd_rn(keep, got);
  }
}

// K4's sums with the product on the CUDA cores (kDot == 2): lane l's row
// l % 16 of the unit against queries 4 (l / 16) + jj, the totals and the
// current 64 dims' sums.
struct FsSeqAcc {
  float dot[4], l1[4], linf[4], cdot[4], cl1[4];
};

// One box of the unit in that case, every dim in ascending order: per
// (row, query) the fmaf of row and query into the 64 dims' sum (and |u - q|
// into the L1's), added to the totals where `fold` (the box ends 64 dims or
// the row). m: the magnitude of the lane's row.
template <typename RowT, bool kL1, bool kLinf, bool kFull>
__device__ __forceinline__ void fs_box_seq(const uint8_t* unit, const float* qbox, int pitch,
                                           int live_q, int lane, float m, bool fold,
                                           FsSeqAcc& acc) {
  constexpr int kE = FsRow<RowT>::kValues;
  const int r = lane & 15, q0 = 4 * (lane >> 4);
#pragma unroll 2
  for (int c = 0; c < kFsBoxBytes / 16; ++c) {
    const uint4 raw = fs_chunk(unit, r, c);
#pragma unroll
    for (int s = 0; s < kE / 4; ++s) {
      float x[4], u[4];
      FsRow<RowT>::quad(raw, s, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) u[e] = __fmul_rn(x[e], m);
      const float* qc = qbox + c * kE + 4 * s;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (kFull || q0 + jj < live_q) {
          const float4 qv = *reinterpret_cast<const float4*>(qc + (size_t)(q0 + jj) * pitch);
          const float qe[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc.cdot[jj] = fmaf(x[e], qe[e], acc.cdot[jj]);
            const float df = __fsub_rn(u[e], qe[e]);
            if (kL1) acc.cl1[jj] += fabsf(df);
            if (kLinf) acc.linf[jj] = fmaxf(acc.linf[jj], fabsf(df));
          }
        }
      }
    }
  }
  if (fold) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      acc.dot[jj] += acc.cdot[jj];
      acc.cdot[jj] = 0.f;
      if (kL1) {
        acc.l1[jj] += acc.cl1[jj];
        acc.cl1[jj] = 0.f;
      }
    }
  }
}

// (av, ai) ranks before (bv, bi): the higher score, then the lower row.
__device__ __forceinline__ bool fs_better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// One warp merges a unit's 16 scores of one query (`sc`; rows row0 ..,
// `valid` of them in the gallery) into the query's kept list (lv, li: kk
// entries, best first; free slots hold (-inf, INT_MAX)). The list comes
// into registers (lane l holds entries l and l + 32); the candidates that
// rank before the kk-th kept entry are inserted one by one, best-ranked
// lane first: each one's place is the number of kept entries that rank
// before it (two ballots), the entries from there on move one place down
// (shuffles) and the last falls off. Past the first units of a list about
// one candidate in a unit enters, so a merge costs a few dozen
// instructions whatever kk.
__device__ __forceinline__ void fs_merge(const float* sc, int row0, int valid, float* lv, int* li,
                                         int kk, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  float e0v = lane < kk ? lv[lane] : -INFINITY, e1v = lane + 32 < kk ? lv[lane + 32] : -INFINITY;
  int e0i = lane < kk ? li[lane] : INT_MAX, e1i = lane + 32 < kk ? li[lane + 32] : INT_MAX;
  float cv = -INFINITY;
  int ci = INT_MAX;  // not a candidate: a lane past the unit's rows in the gallery
  if (lane < kFsUnitRows && lane < valid) {
    cv = sc[lane];
    ci = row0 + lane;
  }
  const int last = kk - 1;
  const float kv = __shfl_sync(kAll, last < 32 ? e0v : e1v, last & 31);
  const int ki = __shfl_sync(kAll, last < 32 ? e0i : e1i, last & 31);
  for (unsigned enter = __ballot_sync(kAll, ci != INT_MAX && fs_better(cv, ci, kv, ki)); enter;
       enter &= enter - 1) {
    const int src = __ffs(enter) - 1;
    const float v = __shfl_sync(kAll, cv, src);
    const int id = __shfl_sync(kAll, ci, src);
    const int pos = __popc(__ballot_sync(kAll, lane < kk && fs_better(e0v, e0i, v, id))) +
                    __popc(__ballot_sync(kAll, lane + 32 < kk && fs_better(e1v, e1i, v, id)));
    if (pos >= kk) continue;  // the same for every lane: an earlier insertion pushed it out
    const float up0v = __shfl_up_sync(kAll, e0v, 1), up1v = __shfl_up_sync(kAll, e1v, 1);
    const int up0i = __shfl_up_sync(kAll, e0i, 1), up1i = __shfl_up_sync(kAll, e1i, 1);
    const float l31v = __shfl_sync(kAll, e0v, 31);  // entry 31 moves to entry 32
    const int l31i = __shfl_sync(kAll, e0i, 31);
    if (lane == pos) {
      e0v = v;
      e0i = id;
    } else if (lane > pos) {
      e0v = up0v;
      e0i = up0i;
    }
    if (lane + 32 == pos) {
      e1v = v;
      e1i = id;
    } else if (lane + 32 > pos) {
      e1v = lane == 0 ? l31v : up1v;
      e1i = lane == 0 ? l31i : up1i;
    }
  }
  __syncwarp();
  if (lane < kk) {
    lv[lane] = e0v;
    li[lane] = e0i;
  }
  if (lane + 32 < kk) {
    lv[lane + 32] = e1v;
    li[lane + 32] = e1i;
  }
  __syncwarp();
}

// A unit's scores (`scratch`: kFsKeep floats per query, -inf past the
// gallery) into the kept lists of its `count` queries. Units arrive in
// ascending row order, so a score equal to the kk-th kept one ranks after
// it: lane j tests query j at once (some score strictly higher, or the list
// not full), and the warp merges only the queries that pass.
__device__ __forceinline__ void fs_merge_unit(const float* scratch, int count, int row0,
                                              int valid, float* lv, int* li, int kk, int lane) {
  bool enter = false;
  if (lane < count) {
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kFsUnitRows; ++r) mx = fmaxf(mx, scratch[lane * kFsKeep + r]);
    const int last = lane * kk + kk - 1;
    enter = mx > lv[last] || li[last] == INT_MAX;
  }
  for (unsigned need = __ballot_sync(0xffffffffu, enter); need; need &= need - 1) {
    const int j = __ffs(need) - 1;
    fs_merge(scratch + j * kFsKeep, row0, valid, lv + j * kk, li + j * kk, kk, lane);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

enum FsKind { kFsPlanes = 0, kFsScores = 1, kFsTopk = 2 };

struct F32SweepArgs {
  const float* q;     // (nq, d) f32
  const float* qn;    // (nq,) their norms
  const float* qpad;  // (nq rounded up to 8, q_pitch) zero-padded queries, where not resident
  const void* rows;   // (n, d) f32 or bf16 unit rows
  const float* mags;  // (n,)
  float* out;         // K6 (5, nq, n); K7 (nq, n); K4 (lists, nq, kk) scores
  int* out_i;         // K4 (lists, nq, kk) rows
  const float* wdev;  // K7: 5 weights on the device
  Weights w;          // K4: static weights
  int nq, n, d, kk;
};

// K6 (kFsPlanes: five planes, direct L2), K7 (kFsScores: run-time weights,
// every term) and K4 (kFsTopk: static weights, the warp's top-kk lists) over
// one sweep. kDot: 0 no product, 1 the product in split TF32 on the tensor
// cores, 2 on the CUDA cores (K4 with the Gram-form L2, fs_box_seq). The
// producer warp and the consumers walk the same sequence of (tile, box)
// stages.
template <int kKind, typename RowT, int kQW, int kDot, bool kL1, bool kLinf>
__global__ void __launch_bounds__(kSwThreads, 1)
    f32_sweep_kernel(const __grid_constant__ CUtensorMap map, F32SweepArgs a, F32SweepPlan p) {
  constexpr bool kSq = kKind == kFsPlanes;
  constexpr bool kSweep = kDot || kL1 || kLinf;
  constexpr bool kSeq = kDot == 2;
  constexpr int kNG = kQW / 8;
  static_assert(!kSeq || (kKind == kFsTopk && kQW == 8), "the CUDA-core product is K4's");
  extern __shared__ __align__(16) uint8_t sweep_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kSwMaxStages];  // full[s], then empty[s]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t base = smem_u32(sweep_smem);
  const uint32_t ring = (base + kSwAlign - 1) & ~(uint32_t)(kSwAlign - 1);
  uint8_t* const ring_ptr = sweep_smem + (ring - base);
  float* const s_q = reinterpret_cast<float*>(ring_ptr + (size_t)p.stages * p.stage_bytes);
  float* const s_keep = s_q + (size_t)p.q_rows * p.q_pitch;  // K4: per warp lists, then scratch
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[kSwMaxStages]);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, p.tma ? 1 : 32);  // the expect-tx arrival, or every copying lane
      mbar_init(empty0 + 8 * s, kSwWarps);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kSwWarps) {  // the producer
    if constexpr (kSweep) {
      const RowT* rows = static_cast<const RowT*>(a.rows);
      const int box_bytes = p.tile_rows * kFsBoxBytes;
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int b0 = 0; b0 < p.boxes; b0 += p.stage_boxes) {
          const int nb = p.boxes - b0 < p.stage_boxes ? p.boxes - b0 : p.stage_boxes;
          const uint32_t full = full0 + 8 * s, empty = empty0 + 8 * s;
          // the stage's previous use released; parity 1 passes at once on the
          // first round
          if (p.tma) {
            if (lane == 0) {
              mbar_wait(empty, phase ^ 1);
              mbar_arrive_expect_tx(full, nb * box_bytes);
              for (int j = 0; j < nb; ++j) {
                tma_load_2d(ring + s * p.stage_bytes + j * box_bytes, &map, full,
                            (b0 + j) * p.box_dims, tile * p.tile_rows);
              }
            }
          } else {
            mbar_wait(empty, phase ^ 1);
            for (int j = 0; j < nb; ++j) {
              copy_box(ring_ptr + (size_t)s * p.stage_bytes + j * box_bytes, rows, a.n, a.d,
                       tile * p.tile_rows, p.tile_rows, b0 + j, lane);
            }
            mbar_arrive(full);
          }
          if (++s == p.stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int units = kSwWarps / p.groups;
  const int ru = warp % units, grp = warp / units;
  const int pass0 = blockIdx.y * p.groups * kQW;  // the pass's first query
  const int qs = grp * kQW;                        // the unit's first query in the pass
  const int qg = pass0 + qs;                       // and in the call
  const int live_q = a.nq - qg;                    // queries of the unit: those below kQW
  const int count = live_q < kQW ? live_q : kQW;
  if (p.resident) {
    const int cols = p.boxes * p.box_dims;
    for (int i = tid; i < p.q_rows * cols; i += kSwWarps * 32) {
      const int r = i / cols, c = i - r * cols;
      s_q[(size_t)r * p.q_pitch + c] =
          (pass0 + r < a.nq && c < a.d) ? a.q[(size_t)(pass0 + r) * a.d + c] : 0.f;
    }
  }
  float* lv = nullptr;
  int* li = nullptr;
  float* scratch = nullptr;
  if constexpr (kKind == kFsTopk) {
    lv = s_keep + (size_t)warp * kQW * a.kk * 2;
    li = reinterpret_cast<int*>(lv + (size_t)kQW * a.kk);
    scratch = s_keep + (size_t)kSwWarps * kQW * a.kk * 2 + warp * kQW * kFsKeep;
    for (int i = lane; i < kQW * a.kk; i += 32) {
      lv[i] = -INFINITY;
      li[i] = INT_MAX;
    }
  }
  Weights w = a.w;
  if constexpr (kKind == kFsScores) {
#pragma unroll
    for (int i = 0; i < 5; ++i) w.w[i] = a.wdev[i];
    w.live = 31;
  }
  consumers_sync();

  const int box_bytes = p.tile_rows * kFsBoxBytes;
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int row0 = tile * p.tile_rows + kFsUnitRows * ru;  // the unit's first row
    const bool active = qg < a.nq && row0 < a.n;             // the same for the whole warp
    const float m0 = row0 + g < a.n ? a.mags[row0 + g] : 0.f;
    const float m1 = row0 + g + 8 < a.n ? a.mags[row0 + g + 8] : 0.f;
    const int rs = row0 + (lane & 15);  // kSeq: the lane's row
    const float ms = kSeq && rs < a.n ? a.mags[rs] : 0.f;
    FsAcc<kQW> acc;
    FsSeqAcc sacc;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      sacc.dot[jj] = sacc.l1[jj] = sacc.linf[jj] = sacc.cdot[jj] = sacc.cl1[jj] = 0.f;
    }
#pragma unroll
    for (int nn = 0; nn < kNG; ++nn) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc.dot[nn][k] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < FsAcc<kQW>::kD; ++j) acc.l1[i][j] = acc.linf[i][j] = acc.sq[i][j] = 0.f;
    }
    if constexpr (kSweep) {
      // the unit's boxes, with the queries read from shared memory (the
      // compiler then issues shared-memory loads) or from the padded copy
      auto sweep = [&](const float* qunit) {
        for (int b0 = 0; b0 < p.boxes; b0 += p.stage_boxes) {
          mbar_wait(full0 + 8 * s, phase);
          if (active) {
            const int nb = p.boxes - b0 < p.stage_boxes ? p.boxes - b0 : p.stage_boxes;
            const uint8_t* unit =
                ring_ptr + (size_t)s * p.stage_bytes + kFsUnitRows * ru * kFsBoxBytes;
            const float* qbox = qunit + b0 * p.box_dims;
            for (int j = 0; j < nb; ++j, unit += box_bytes, qbox += p.box_dims) {
              if constexpr (kSeq) {
                // 64 dims: two f32 boxes or one bf16 box
                const int b = b0 + j;
                const bool fold = (sizeof(RowT) == 2 || (b & 1)) || b + 1 == p.boxes;
                if (live_q >= kQW) {
                  fs_box_seq<RowT, kL1, kLinf, true>(unit, qbox, p.q_pitch, live_q, lane, ms,
                                                     fold, sacc);
                } else {
                  fs_box_seq<RowT, kL1, kLinf, false>(unit, qbox, p.q_pitch, live_q, lane, ms,
                                                      fold, sacc);
                }
              } else if (live_q >= kQW) {
                fs_box<RowT, kQW, kDot == 1, kL1, kLinf, kSq, true>(unit, qbox, p.q_pitch,
                                                                    live_q, g, t, m0, m1, acc);
              } else {
                fs_box<RowT, kQW, kDot == 1, kL1, kLinf, kSq, false>(unit, qbox, p.q_pitch,
                                                                     live_q, g, t, m0, m1, acc);
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
          if (++s == p.stages) {
            s = 0;
            phase ^= 1;
          }
        }
      };
      if (p.resident) {
        sweep(s_q + (size_t)qs * p.q_pitch);
      } else {
        sweep(a.qpad + ((size_t)pass0 + qs) * p.q_pitch);
      }
    }
    if (!active) continue;
    if constexpr (kSeq) {
      // the lane's (row, query) scores into the scratch
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * (lane >> 4) + jj;
        float sc = -INFINITY;  // rows past n and queries past nq
        if (rs < a.n && j < count) {
          sc = weighted<false>(w, sacc.dot[jj], sacc.l1[jj], sacc.linf[jj], ms, a.qn[qg + j],
                               a.d);
          if (!(sc == sc)) sc = -INFINITY;
        }
        scratch[j * kFsKeep + (lane & 15)] = sc;
      }
    } else {
      // lane t's queries 2t, 2t + 1 of each 8: the sums of the differences
      float l1s[2][2] = {}, linfs[2][2] = {}, sqs[2][2] = {};
      if constexpr (kQW == 8) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (kL1) fs_quad_scatter<false>(acc.l1[i], t, l1s[i]);
          if constexpr (kLinf) fs_quad_scatter<true>(acc.linf[i], t, linfs[i]);
          if constexpr (kSq) fs_quad_scatter<false>(acc.sq[i], t, sqs[i]);
        }
      }
      const float mrow[2] = {m0, m1};
#pragma unroll
      for (int nn = 0; nn < kNG; ++nn) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * nn + 2 * t + c;  // the query within the unit
          const float qnj = j < count ? a.qn[qg + j] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + g + 8 * i;
            const float dot = acc.dot[nn][2 * i + c];
            if constexpr (kKind == kFsTopk) {
              float sc = -INFINITY;  // rows past n and queries past nq
              if (row < a.n && j < count) {
                sc = weighted<false>(w, dot, l1s[i][c], linfs[i][c], mrow[i], qnj, a.d);
                if (!(sc == sc)) sc = -INFINITY;
              }
              scratch[j * kFsKeep + g + 8 * i] = sc;
            } else if (row < a.n && j < count) {
              float* o = a.out + (size_t)(qg + j) * a.n + row;
              if constexpr (kKind == kFsPlanes) {
                const size_t plane = (size_t)a.nq * a.n;
                o[0] = cosine(dot, qnj);
                o[plane] = l1_term(l1s[i][c], a.d);
                o[2 * plane] = l2_term(sqs[i][c], a.d);
                o[3 * plane] = linfs[i][c];
                o[4 * plane] = mag_term(mrow[i], qnj);
              } else {
                o[0] = weighted<false>(w, dot, l1s[i][c], linfs[i][c], mrow[i], qnj, a.d);
              }
            }
          }
        }
      }
    }
    if constexpr (kKind == kFsTopk) {
      __syncwarp();
      fs_merge_unit(scratch, count, row0, a.n - row0, lv, li, a.kk, lane);
    }
  }
  if constexpr (kKind == kFsTopk) {
    // the warp's lists: list blockIdx.x * units + ru of its queries
    const size_t list = (size_t)blockIdx.x * units + ru;
    for (int i = lane; i < count * a.kk; i += 32) {
      const int j = i / a.kk, s = i - j * a.kk;
      const size_t o = (list * a.nq + qg + j) * a.kk + s;
      a.out[o] = lv[j * a.kk + s];
      a.out_i[o] = li[j * a.kk + s];
    }
  }
}

// A (d, n) row matrix as boxes of (128 bytes, tile rows), 128-byte swizzle,
// zeros past its edges.
inline bool fs_encode(CUtensorMap* map, const void* rows, int n, int d, int row_bytes,
                      const F32SweepPlan& p) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)p.box_dims, (cuuint32_t)p.tile_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map,
                        row_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(rows), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
