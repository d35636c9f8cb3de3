// Hopper (sm_90a) fused metric kernels over a (unit row, magnitude) gallery.
//
// They replace the TPU kernels of image_retrieval_tpu/ops/pallas_kernels.py:
//   K6  _fused_kernel (l.45)  under fused_all_metrics (l.78): the five metric
//       planes (cosine, L1/d, direct L2/sqrt(d), Linf, |dmag|) in one read;
//   K7  _combo_kernel (l.124) under fused_optimized_scores (l.541): the
//       weighted score with weights read at run time, Gram-form L2;
//   K5  _make_int8_combo_kernel (l.162) and _make_int8_combo_kernel_v2
//       (l.275) under fused_optimized_scores_int8_pallas (l.234) and
//       ..._pallas_v2 (l.349): the weighted score over int8 rows. The two
//       bodies have one contract and differ in how they schedule the TPU's
//       vector unit, so one kernel here serves both;
//   K4  _make_combo_topk_kernel (l.399) under fused_optimized_topk (l.480):
//       the weighted score and the top-k selection in one kernel, so that the
//       (Q, N) score plane never reaches device memory.
// Each computes its own row x query products; no library call takes part.
//
// What bounds them on this card. At Q = 1 the read of the rows (2 KB per
// f32 row at D = 512, 768 B per int8 row at D = 768). From a few queries on,
// for K4, K6 and K7 the CUDA cores: per (query, row, dim) one FMA for the
// product and, where L1/Linf (or K6's direct L2) are live, a subtract, an
// add, a max (and an FMA), against 33.5 T such operations a second; the
// planes K6 writes (20 B per query and row) stay under that. K5 has its own
// sweep (int8_sweep_sm90.cuh, which says what bounds it).
//
// What the design of K4, K6 and K7 does about it. Simple and right first:
//   * a block of 128 threads takes a tile of 64 rows; the tile comes into
//     shared memory 64 dims at a time, converted to f32 on the way (16-byte
//     loads), beside the same 64 dims of 32 queries;
//   * a warp is a query group: lane r holds the sums of rows r and r + 32
//     against the group's 8 queries in registers. Per four dims it reads
//     each row's four floats once (conflict-free 16-byte reads) and each
//     query's as a broadcast: 10 reads of shared memory for 64 products (a
//     16-byte read costs four cycles broadcast or not; with one row per
//     thread these reads outweighed the products). A group that has all 8
//     queries runs a loop without conditions, so the compiler interleaves
//     the queries' reads and sums. There is no reduction across threads, and
//     a warp's stores to the (Q, N) outputs are 128 contiguous bytes;
//   * more than 32 queries take further passes (grid.y), which re-read the
//     tile through L2;
//   * weights whose bit in `live` is clear choose an instantiation without
//     the product, without the L1 sum or without the Linf max, so a dead
//     term costs nothing (with L1 and Linf dead no difference is formed and
//     the kernel is one FMA per element);
//   * K4 writes a tile's scores into shared memory (over the staged rows),
//     and one warp per query merges them into the query's running top-k:
//     kk rounds of extracting the best (score, then lowest row) of the 64
//     scores and the kk kept ones with warp shuffles, skipped when no score
//     of the tile beats the kk-th kept one. A block walks many tiles, so
//     there are few candidate lists to merge afterwards. A NaN score counts
//     as -inf, and a row whose score is -inf is still a candidate under its
//     own row number: only columns past N are never returned.
// K5 rounds where the int8 scorer rounds: the query and the reconstruction
// bf16(int8 * bf16(scale*mag)) once each, the difference u - q once more
// (one bf16 fma: the exact difference rounded once; the plain version's
// f32 difference of two bf16 values is exact unless their exponents are more
// than 16 apart, and then rounding twice gives the larger value, as rounding
// once does), every product exact, the sums in f32. Its sweep streams the
// rows through a TMA ring once for all queries, takes the product and the
// L1 sum on the tensor cores and the differences in packed bf16
// (int8_sweep_sm90.cuh).

#include "fused_metrics.cuh"
#include "int8_sweep_sm90.cuh"

#include <string.h>

namespace {

using namespace fm;

// A thread's place in a tile: lane r holds rows r and r + 32 (`in`: inside
// the gallery) against the up to kQT queries from qbase of its warp's group.
struct TileCtx {
  int r, grp, q0, qbase, qcount, tile_rows;
  long long row0;
  bool in[kRT];
};

__device__ __forceinline__ TileCtx tile_ctx(long long tile, int n, int nq) {
  TileCtx c;
  c.r = threadIdx.x & 31;
  c.grp = threadIdx.x >> 5;
  c.row0 = tile * kRows;
  c.tile_rows = (int)min((long long)kRows, (long long)n - c.row0);
  c.q0 = blockIdx.y * kQP;
  c.qbase = c.q0 + c.grp * kQT;
  c.qcount = max(0, min(kQT, nq - c.qbase));
#pragma unroll
  for (int t = 0; t < kRT; ++t) c.in[t] = c.r + 32 * t < c.tile_rows;
  return c;
}

// A per-row operand of the thread's rows, 0 outside the gallery.
__device__ __forceinline__ void row_values(const TileCtx& c, const float* v, float* out) {
#pragma unroll
  for (int t = 0; t < kRT; ++t) out[t] = c.in[t] ? v[c.row0 + c.r + 32 * t] : 0.f;
}

// K6: five planes, direct L2.
__global__ void __launch_bounds__(kThreads, 3) all_metrics_kernel(
    const float* __restrict__ q, const float* __restrict__ qn, const float* __restrict__ rows,
    const float* __restrict__ mags, float* __restrict__ out, int nq, int n, int d, bool vec,
    bool qvec) {
  __shared__ __align__(16) float s_rows[kRows * kRStride];
  __shared__ __align__(16) float s_q[kQP * kDC];
  const TileCtx c = tile_ctx(blockIdx.x, n, nq);
  float m[kRT];
  row_values(c, mags, m);
  Acc tot;
  sweep_tile<float, true, true, true, true>(s_rows, s_q, rows + (size_t)c.row0 * d, c.tile_rows,
                                             q, c.q0, nq, d, vec, qvec, c.r, c.grp, c.qcount, m,
                                             tot);
  const size_t plane = (size_t)nq * n;
#pragma unroll
  for (int j = 0; j < kQT; ++j) {
    if (j < c.qcount) {
      const float qnj = qn[c.qbase + j];
#pragma unroll
      for (int t = 0; t < kRT; ++t) {
        if (c.in[t]) {
          float* o = out + (size_t)(c.qbase + j) * n + c.row0 + c.r + 32 * t;
          o[0] = cosine(tot.dot[t][j], qnj);
          o[plane] = l1_term(tot.l1[t][j], d);
          o[2 * plane] = l2_term(tot.sq[t][j], d);
          o[3 * plane] = tot.linf[t][j];
          o[4 * plane] = mag_term(m[t], qnj);
        }
      }
    }
  }
}

// K7: run-time weights, every term taken.
__global__ void __launch_bounds__(kThreads, 4) optimized_scores_kernel(
    const float* __restrict__ q, const float* __restrict__ qn, const float* __restrict__ wdev,
    const float* __restrict__ rows, const float* __restrict__ mags, float* __restrict__ out,
    int nq, int n, int d, bool vec, bool qvec) {
  __shared__ __align__(16) float s_rows[kRows * kRStride];
  __shared__ __align__(16) float s_q[kQP * kDC];
  const TileCtx c = tile_ctx(blockIdx.x, n, nq);
  float m[kRT];
  row_values(c, mags, m);
  Weights w;
#pragma unroll
  for (int i = 0; i < 5; ++i) w.w[i] = wdev[i];
  w.live = 31;
  Acc tot;
  sweep_tile<float, true, true, true, false>(s_rows, s_q, rows + (size_t)c.row0 * d,
                                              c.tile_rows, q, c.q0, nq, d, vec, qvec, c.r, c.grp,
                                              c.qcount, m, tot);
#pragma unroll
  for (int j = 0; j < kQT; ++j) {
    if (j < c.qcount) {
      const float qnj = qn[c.qbase + j];
#pragma unroll
      for (int t = 0; t < kRT; ++t) {
        if (c.in[t]) {
          out[(size_t)(c.qbase + j) * n + c.row0 + c.r + 32 * t] =
              weighted<false>(w, tot.dot[t][j], tot.l1[t][j], tot.linf[t][j], m[t], qnj, d);
        }
      }
    }
  }
}

// (av, ai) ranks before (bv, bi): the higher score, then the lower row.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// One warp merges a tile's kRows scores of one query into the query's kept
// list (kk entries, best first). Tiles arrive in ascending row order, so a
// score equal to the kk-th kept one ranks after it and the tile is skipped
// unless some score is strictly higher or the list is not full yet. The
// tile's first `tile_rows` scores are rows of the gallery, candidates under
// their own row numbers whatever their score; the rest rank after every row.
__device__ __forceinline__ void merge_tile(const float* sc, int row0, int tile_rows, float* lv,
                                           int* li, int kk, int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  float v[4];
  int id[4];
  v[0] = sc[lane];
  v[1] = sc[lane + 32];
  float tmax = fmaxf(v[0], v[1]);
#pragma unroll
  for (int off = 16; off; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
  if (!(tmax > lv[kk - 1]) && li[kk - 1] != INT_MAX) return;
  id[0] = lane < tile_rows ? row0 + lane : INT_MAX;
  id[1] = lane + 32 < tile_rows ? row0 + lane + 32 : INT_MAX;
  v[2] = lane < kk ? lv[lane] : -INFINITY;
  id[2] = lane < kk ? li[lane] : INT_MAX;
  v[3] = lane + 32 < kk ? lv[lane + 32] : -INFINITY;
  id[3] = lane + 32 < kk ? li[lane + 32] : INT_MAX;
  __syncwarp();  // every lane holds its kept entries before any is overwritten
  for (int round = 0; round < kk; ++round) {
    float bv = v[0];
    int bi = id[0];
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      if (better(v[i], id[i], bv, bi)) {
        bv = v[i];
        bi = id[i];
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      lv[round] = bv;
      li[round] = bi;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (id[i] == bi && bi != INT_MAX) {
        v[i] = -INFINITY;
        id[i] = INT_MAX;
      }
    }
  }
  __syncwarp();
}

// K4: the weighted score and the block's top-kk per query.
template <typename RowT, bool kDot, bool kL1, bool kLinf>
__global__ void __launch_bounds__(kThreads, 4) optimized_topk_kernel(
    const float* __restrict__ q, const float* __restrict__ qn, const RowT* __restrict__ rows,
    const float* __restrict__ mags, float* __restrict__ out_v, int* __restrict__ out_i, int nq,
    int n, int d, int kk, int tiles_per_block, Weights w, bool vec, bool qvec) {
  __shared__ __align__(16) float s_rows[kRows * kRStride];
  __shared__ __align__(16) float s_q[kQP * kDC];
  __shared__ float s_lv[kQP * kMaxK];
  __shared__ int s_li[kQP * kMaxK];
  float* s_scores = s_rows;  // (kQP, kRows), once the tile's last chunk is read
  static_assert(kQP * kRows <= kRows * kRStride, "scores fit over the staged rows");
  static_assert(kRows == 64 && kMaxK == 64, "merge_tile holds two of each per lane");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kQP * kMaxK; i += kThreads) {
    s_lv[i] = -INFINITY;
    s_li[i] = INT_MAX;
  }
  const int ntiles = (n + kRows - 1) / kRows;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(ntiles, t_begin + tiles_per_block);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const TileCtx c = tile_ctx(tile, n, nq);
    float m[kRT];
    row_values(c, mags, m);
    Acc tot;
    sweep_tile<RowT, kDot, kL1, kLinf, false>(s_rows, s_q, rows + (size_t)c.row0 * d,
                                                     c.tile_rows, q, c.q0, nq, d, vec, qvec, c.r,
                                                     c.grp, c.qcount, m, tot);
    __syncthreads();  // the staged rows are read, the last tile's scores merged
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      const float qnj = j < c.qcount ? qn[c.qbase + j] : 0.f;
#pragma unroll
      for (int t = 0; t < kRT; ++t) {
        float s = -INFINITY;  // rows past n and queries past nq
        if (c.in[t] && j < c.qcount) {
          s = weighted<false>(w, tot.dot[t][j], tot.l1[t][j], tot.linf[t][j], m[t], qnj, d);
          if (!(s == s)) s = -INFINITY;
        }
        s_scores[(c.grp * kQT + j) * kRows + c.r + 32 * t] = s;
      }
    }
    __syncthreads();
    for (int ql = warp; ql < kQP; ql += kThreads / 32) {
      if (c.q0 + ql < nq) {
        merge_tile(s_scores + ql * kRows, (int)c.row0, c.tile_rows, s_lv + ql * kMaxK,
                   s_li + ql * kMaxK, kk, lane);
      }
    }
  }
  __syncthreads();
  const int q0 = blockIdx.y * kQP;
  for (int i = threadIdx.x; i < kQP * kk; i += kThreads) {
    const int ql = i / kk, s = i - ql * kk;
    if (q0 + ql < nq) {
      const size_t o = ((size_t)blockIdx.x * nq + q0 + ql) * kk + s;
      out_v[o] = s_lv[ql * kMaxK + s];
      out_i[o] = s_li[ql * kMaxK + s];
    }
  }
}

bool bad_shape(int nq, int n, int d) { return nq <= 0 || n <= 0 || d <= 0; }

// 16-byte loads are possible: every row of d elements starts 16-byte aligned.
template <typename RowT>
bool can_vec(const void* rows, int d) {
  return d % (16 / (int)sizeof(RowT)) == 0 && (uintptr_t)rows % 16 == 0;
}

dim3 tile_grid(int n, int nq) { return dim3((n + kRows - 1) / kRows, (nq + kQP - 1) / kQP); }

// Which sums the live weights need, as the case of IRT_LIVE_CASES: bit 0
// the product (cosine or the Gram-form L2), bit 1 the L1 sum, bit 2 the
// Linf max.
int live_case(const Weights& w) {
  return ((w.live & (1 | 4)) ? 1 : 0) | ((w.live & 2) ? 2 : 0) | ((w.live & 8) ? 4 : 0);
}

// One launch per case of live_case: IRT_LAUNCH(dot, l1, linf).
#define IRT_LIVE_CASE(c)                                        \
  case c:                                                       \
    IRT_LAUNCH(((c) & 1) != 0, ((c) & 2) != 0, ((c) & 4) != 0); \
    break;
#define IRT_LIVE_CASES(code)                                                        \
  switch (code) {                                                                   \
    IRT_LIVE_CASE(0) IRT_LIVE_CASE(1) IRT_LIVE_CASE(2) IRT_LIVE_CASE(3)             \
    IRT_LIVE_CASE(4) IRT_LIVE_CASE(5) IRT_LIVE_CASE(6) IRT_LIVE_CASE(7)             \
  }

Weights make_weights(float w0, float w1, float w2, float w3, float w4, int live) {
  Weights w;
  w.w[0] = w0;
  w.w[1] = w1;
  w.w[2] = w2;
  w.w[3] = w3;
  w.w[4] = w4;
  w.live = live & 31;
  return w;
}

// K5: the weighted score over int8 rows in the int8 scorer's arithmetic, on
// the sweep of int8_sweep_sm90.cuh. Block b walks tiles b, b + grid, ...;
// per tile and pass, warp w takes row unit w % (8 / groups) and query group
// w / (8 / groups). The producer warp and the consumers walk the same
// sequence of (tile, pass, box) stages.
template <bool kDot, bool kL1, bool kLinf, int kQW>
__global__ void __launch_bounds__(kSwThreads, 1) optimized_scores_int8_kernel(
    const __grid_constant__ CUtensorMap map, const int8_t* __restrict__ rows,
    const float* __restrict__ q, const float* __restrict__ qn, const float* __restrict__ scales,
    const float* __restrict__ mags, float* __restrict__ out, int nq, int n, int d, Weights w,
    Int8SweepPlan p) {
  constexpr bool kSweep = kDot || kL1 || kLinf;
  constexpr int kNG = kQW / 8;
  extern __shared__ __align__(16) uint8_t sweep_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kSwMaxStages];  // full[s], then empty[s]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t base = smem_u32(sweep_smem);
  const uint32_t ring = (base + kSwAlign - 1) & ~(uint32_t)(kSwAlign - 1);
  uint8_t* const ring_ptr = sweep_smem + (ring - base);
  __nv_bfloat16* const sq =
      reinterpret_cast<__nv_bfloat16*>(ring_ptr + (size_t)p.stages * p.stage_bytes);
  float* const s_qn = reinterpret_cast<float*>(sq + (size_t)p.q_rows * p.q_pitch);
  constexpr int kPitch = kQW + 1, kPlane = kSwUnitRows * kPitch;
  float* const scratch = s_qn + p.q_rows + warp * kPlane * sweep_planes(kQW);
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
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int pass = 0; pass < p.passes; ++pass) {
          for (int b = 0; b < p.boxes; ++b, ++it) {
            const int s = it % p.stages;
            const uint32_t full = full0 + 8 * s, empty = empty0 + 8 * s;
            // the stage's previous use released; parity 1 passes at once on
            // the first round
            const uint32_t parity = ((it / p.stages) & 1) ^ 1;
            if (p.tma) {
              if (lane == 0) {
                mbar_wait(empty, parity);
                mbar_arrive_expect_tx(full, p.stage_bytes);
                tma_load_2d(ring + s * p.stage_bytes, &map, full, b * kSwBoxDims,
                            tile * p.tile_rows);
              }
            } else {
              mbar_wait(empty, parity);
              copy_box(ring_ptr + (size_t)s * p.stage_bytes, rows, n, d, tile * p.tile_rows,
                       p.tile_rows, b, lane);
              mbar_arrive(full);
            }
          }
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int units = kSwWarps / p.groups;
  const int ru = warp % units, grp = warp / units;
  const int pass_q = p.groups * kQW;
  uint32_t sel[4][2];  // the L1 mma's B operand for query pair pp (columns 2 pp, 2 pp + 1)
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    sel[pp][0] = g == 2 * pp ? kBf16One2 : 0u;
    sel[pp][1] = g == 2 * pp + 1 ? kBf16One2 : 0u;
  }
  if (p.resident) {
    load_query_rows(sq, s_qn, q, qn, 0, p.q_rows, nq, d, p.boxes, p.q_pitch);
    consumers_sync();
  }
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int row0 = tile * p.tile_rows + kSwUnitRows * ru;  // the unit's first row
    // lane l's row row0 + l: its magnitude and scale, and bf16(scale * mag)
    const float mrow = row0 + lane < n ? mags[row0 + lane] : 0.f;
    const float srow = row0 + lane < n ? scales[row0 + lane] : 0.f;
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(srow, mrow)));
    uint32_t rs2[4];  // bf16(scale * mag) of rows row0 + g + 8 i, in both halves
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t hi = __shfl_sync(0xffffffffu, h, g + 8 * i);
      rs2[i] = hi | (hi << 16);
    }
    for (int pass = 0; pass < p.passes; ++pass) {
      const int qg = pass * pass_q + grp * kQW;  // the unit's first query
      int qs = qg;                               // its row in shared memory
      if (!p.resident) {
        consumers_sync();  // every warp is done with the last pass's queries
        load_query_rows(sq, s_qn, q, qn, pass * pass_q, pass_q, nq, d, p.boxes, p.q_pitch);
        consumers_sync();
        qs = grp * kQW;
      }
      const bool active = qg < nq && row0 < n;  // the same for the whole warp
      const int live_q = nq - qg;                // queries of the unit: those below kQW
      SweepAcc<kQW> acc;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc.l1[m][k] = 0.f;
#pragma unroll
          for (int nn = 0; nn < kNG; ++nn) acc.dot[m][nn][k] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc.lin[i][j] = 0u;
      }
      if constexpr (kSweep) {
        for (int b = 0; b < p.boxes; ++b, ++it) {
          const int s = it % p.stages;
          mbar_wait(full0 + 8 * s, (it / p.stages) & 1);
          if (active) {
            const uint8_t* unit =
                ring_ptr + (size_t)s * p.stage_bytes + kSwUnitRows * ru * kSwBoxDims;
            const __nv_bfloat16* qbox = sq + (size_t)qs * p.q_pitch + b * kSwBoxDims;
            if constexpr (kL1 || kLinf) {
              if (live_q >= kQW) {
                sweep_box_diff<kDot, kL1, kLinf, true>(unit, qbox, p.q_pitch, live_q, g, t, rs2,
                                                       sel, acc);
              } else {
                sweep_box_diff<kDot, kL1, kLinf, false>(unit, qbox, p.q_pitch, live_q, g, t, rs2,
                                                        sel, acc);
              }
            } else if (live_q >= kQW) {
              sweep_box_dot<kQW, true>(unit, qbox, p.q_pitch, live_q, g, t, acc);
            } else {
              sweep_box_dot<kQW, false>(unit, qbox, p.q_pitch, live_q, g, t, acc);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
      }
      if (!active) continue;
      // the sums into the warp's scratch, [row][query] per plane: product,
      // L1, Linf
      float linf[4][2] = {};
      if constexpr (kLinf) linf_of_lane(acc.lin, t, linf);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* at = scratch + (g + 8 * i) * kPitch + 2 * t + c;
          const int k = (i & 1) * 2 + c;
#pragma unroll
          for (int nn = 0; nn < kNG; ++nn) at[8 * nn] = acc.dot[i >> 1][nn][k];
          if constexpr (kL1) at[kPlane] = acc.l1[i >> 1][k];
          if constexpr (kLinf) at[2 * kPlane] = linf[i][c];
        }
      }
      __syncwarp();
      // lane l scores row row0 + l against the unit's queries: 128
      // contiguous bytes of the (Q, N) plane a query
      if (row0 + lane < n) {
        const float* mine = scratch + lane * kPitch;
        const int count = live_q < kQW ? live_q : kQW;
#pragma unroll 2
        for (int j = 0; j < count; ++j) {
          const float l1 = kL1 ? mine[kPlane + j] : 0.f;
          const float lmax = kLinf ? mine[2 * kPlane + j] : 0.f;
          out[(size_t)(qg + j) * n + row0 + lane] =
              weighted<true>(w, __fmul_rn(mine[j], srow), l1, lmax, mrow, s_qn[qs + j], d);
        }
      }
      __syncwarp();  // the scratch is read before the next unit writes it
    }
  }
}

// K5's plan on the current device; false where int8_sweep_plan refuses.
bool k5_plan(int nq, int n, int d, int live, const void* rows, Int8SweepPlan* p) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return false;
  }
  return int8_sweep_plan(nq, n, d, live, (uintptr_t)rows % 16 == 0, sms, p);
}

template <bool kDot, bool kL1, bool kLinf, int kQW>
int launch_int8_sweep_as(const CUtensorMap& map, const void* q, const void* qn, const void* rows,
                         const void* scales, const void* mags, void* out, int nq, int n, int d,
                         const Weights& w, const Int8SweepPlan& p, cudaStream_t st) {
  auto kernel = optimized_scores_int8_kernel<kDot, kL1, kLinf, kQW>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  IRT_TRY(kernel<<<p.grid, kSwThreads, p.smem, st>>>(
      map, (const int8_t*)rows, (const float*)q, (const float*)qn, (const float*)scales,
      (const float*)mags, (float*)out, nq, n, d, w, p));
  return 0;
}

// The instantiation of the plan's unit width: 8 queries with L1 or Linf
// live, 32 or 16 with only the product, 16 with no sum at all.
template <bool kDot, bool kL1, bool kLinf>
int launch_int8_sweep(const CUtensorMap& map, const void* q, const void* qn, const void* rows,
                      const void* scales, const void* mags, void* out, int nq, int n, int d,
                      const Weights& w, const Int8SweepPlan& p, cudaStream_t st) {
  constexpr int kQW = (kL1 || kLinf) ? 8 : 16;
  if (kDot && !kL1 && !kLinf && p.qw == 32) {
    return launch_int8_sweep_as<true, false, false, 32>(map, q, qn, rows, scales, mags, out, nq,
                                                        n, d, w, p, st);
  }
  if (p.qw != kQW) return IRT_BAD_ARGS;
  return launch_int8_sweep_as<kDot, kL1, kLinf, kQW>(map, q, qn, rows, scales, mags, out, nq, n,
                                                     d, w, p, st);
}

}  // namespace

extern "C" int irt_fused_metrics_tile_rows(void) { return kRows; }
extern "C" int irt_fused_metrics_max_k(void) { return kMaxK; }

extern "C" int irt_fused_all_metrics(const void* q, const void* qn, const void* rows,
                                     const void* mags, void* out, int nq, int n, int d,
                                     void* stream) {
  if (bad_shape(nq, n, d)) return IRT_BAD_ARGS;
  all_metrics_kernel<<<tile_grid(n, nq), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)qn, (const float*)rows, (const float*)mags, (float*)out, nq,
      n, d, can_vec<float>(rows, d), can_vec<float>(q, d));
  return (int)cudaGetLastError();
}

extern "C" int irt_fused_optimized_scores(const void* q, const void* qn, const void* weights,
                                          const void* rows, const void* mags, void* out, int nq,
                                          int n, int d, void* stream) {
  if (bad_shape(nq, n, d)) return IRT_BAD_ARGS;
  optimized_scores_kernel<<<tile_grid(n, nq), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)qn, (const float*)weights, (const float*)rows,
      (const float*)mags, (float*)out, nq, n, d, can_vec<float>(rows, d),
      can_vec<float>(q, d));
  return (int)cudaGetLastError();
}

extern "C" int irt_fused_optimized_scores_int8(const void* q, const void* qn, const void* rows,
                                               const void* scales, const void* mags, void* out,
                                               int nq, int n, int d, float w0, float w1,
                                               float w2, float w3, float w4, int live,
                                               void* stream) {
  const Weights w = make_weights(w0, w1, w2, w3, w4, live);
  Int8SweepPlan p;
  if (!k5_plan(nq, n, d, w.live, rows, &p)) return IRT_BAD_ARGS;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (p.tma) {
    if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
    // (d, n) int8 as boxes of (128 dims, tile rows), 128-byte swizzle, zeros
    // past its edges
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)d};
    const cuuint32_t box[2] = {(cuuint32_t)kSwBoxDims, (cuuint32_t)p.tile_rows};
    const cuuint32_t elem[2] = {1, 1};
    if (encode_tiled()(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(rows), dims,
                       strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return IRT_BAD_ARGS;
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
#define IRT_LAUNCH(dot, l1, linf) \
  return launch_int8_sweep<dot, l1, linf>(map, q, qn, rows, scales, mags, out, nq, n, d, w, p, st)
  IRT_LIVE_CASES(live_case(w))
#undef IRT_LAUNCH
  return IRT_BAD_ARGS;
}

// K5's launch plan as the kernel would take it on the current device: 0 and
// out[14] = (qw, groups, tile_rows, passes, resident, q_rows, q_pitch, boxes,
// stages, stage_bytes, tma, tiles, grid, smem), or IRT_BAD_ARGS where the
// kernel refuses the shape. `aligned`: the rows' base is 16-byte aligned.
extern "C" int irt_int8_sweep_plan(int nq, int n, int d, int live, int aligned, int sms,
                                   int* out) {
  Int8SweepPlan p;
  if (!int8_sweep_plan(nq, n, d, live & 31, aligned != 0, sms, &p)) return IRT_BAD_ARGS;
  const int v[14] = {p.qw,   p.groups, p.tile_rows,   p.passes, p.resident, p.q_rows, p.q_pitch,
                     p.boxes, p.stages, p.stage_bytes, p.tma,    p.tiles,    p.grid,   p.smem};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

namespace {

template <typename RowT>
int launch_topk(const void* q, const void* qn, const void* rows, const void* mags, void* out_v,
                void* out_i, int nq, int n, int d, int kk, int nblocks, const Weights& w,
                cudaStream_t st) {
  const int ntiles = (n + kRows - 1) / kRows;
  const int tpb = (ntiles + nblocks - 1) / nblocks;
  const dim3 grid(nblocks, (nq + kQP - 1) / kQP);
  const bool vec = can_vec<RowT>(rows, d), qvec = can_vec<float>(q, d);
#define IRT_LAUNCH(dot, l1, linf)                                                        \
  optimized_topk_kernel<RowT, dot, l1, linf><<<grid, kThreads, 0, st>>>(                 \
      (const float*)q, (const float*)qn, (const RowT*)rows, (const float*)mags,          \
      (float*)out_v, (int*)out_i, nq, n, d, kk, tpb, w, vec, qvec)
  IRT_LIVE_CASES(live_case(w))
#undef IRT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int irt_fused_optimized_topk(const void* q, const void* qn, const void* rows,
                                        int rows_bf16, const void* mags, void* out_v,
                                        void* out_i, int nq, int n, int d, int kk, int nblocks,
                                        float w0, float w1, float w2, float w3, float w4,
                                        int live, void* stream) {
  if (bad_shape(nq, n, d) || kk < 1 || kk > kMaxK || kk > n || nblocks < 1) return IRT_BAD_ARGS;
  const Weights w = make_weights(w0, w1, w2, w3, w4, live);
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows_bf16) {
    return launch_topk<__nv_bfloat16>(q, qn, rows, mags, out_v, out_i, nq, n, d, kk, nblocks, w,
                                      st);
  }
  return launch_topk<float>(q, qn, rows, mags, out_v, out_i, nq, n, d, kk, nblocks, w, st);
}
