// The fused metric kernels for Hopper (fused_metrics.cu): their plain C
// interface, bound from Python with ctypes
// (image_retrieval_tpu_torch/ops/_build.py), and, for CUDA translation
// units, the device code K4, K6 and K7 share: the row-tile load with
// on-the-fly conversion from f32 / bf16, the per-(query, row) accumulators,
// and the epilogue that turns them into metric planes or a weighted score
// (K5's too; its sweep is int8_sweep_sm90.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

// Rows of one tile (a block's unit of work) and the largest k of the top-k
// kernel. The wrapper sizes the top-k kernel's grid and candidate buffers
// from them.
int irt_fused_metrics_tile_rows(void);
int irt_fused_metrics_max_k(void);

// All kernels: q (nq, d) f32 queries, unnormalized; qn (nq,) f32 their
// norms; mags (n,) f32 stored magnitudes; rows (n, d) unit rows, row-major
// and contiguous; outputs row-major; everything on the current device and
// enqueued on `stream`. Each returns cudaGetLastError() of its launch
// (0 = ok) or IRT_BAD_ARGS.

// K6. out (5, nq, n) f32: cosine (0 for a zero-norm query), L1/d, direct
// L2/sqrt(d), Linf and |mag - ||q||| of the rows scaled by their magnitudes.
// rows f32.
int irt_fused_all_metrics(const void* q, const void* qn, const void* rows, const void* mags,
                          void* out, int nq, int n, int d, void* stream);

// K7. out (nq, n) f32 = w0*cos - w1*L1 - w2*L2 - w3*Linf - w4*dmag with the
// Gram-form L2; weights: 5 f32 on the device, read when the kernel runs, so
// no term is ever skipped. rows f32.
int irt_fused_optimized_scores(const void* q, const void* qn, const void* weights,
                               const void* rows, const void* mags, void* out, int nq, int n,
                               int d, void* stream);

// K5. The same weighted score over int8 rows with norm-preserving scales
// (n,) f32, in the int8 scorer's arithmetic: query rounded to bf16, exact
// products summed in f32, the L1/Linf differences rounded to bf16 as the
// reconstruction bf16(int8 * bf16(scale*mag)) minus the bf16 query. Bit t
// of `live` says that weight t takes part; a term whose bit is clear costs
// nothing (the L1 sum and the Linf max are dropped one by one). Its sweep
// is its own (int8_sweep_sm90.cuh); IRT_BAD_ARGS for a shape its plan
// refuses (irt_int8_sweep_plan).
int irt_fused_optimized_scores_int8(const void* q, const void* qn, const void* rows,
                                    const void* scales, const void* mags, void* out, int nq,
                                    int n, int d, float w0, float w1, float w2, float w3,
                                    float w4, int live, void* stream);

// K5's launch plan for (nq, n, d, live) with `aligned` (the rows' base is
// 16-byte aligned) on a card of `sms` SMs: 0 and out[14] = (qw, groups,
// tile_rows, passes, resident, q_rows, q_pitch, boxes, stages, stage_bytes,
// tma, tiles, grid, smem), or IRT_BAD_ARGS for a shape the kernel refuses.
int irt_int8_sweep_plan(int nq, int n, int d, int live, int aligned, int sms, int* out);

// K4. The weighted score of K7 (live bits as in K5) with the selection
// inside the kernel: block b sweeps tiles [b*tpb, (b+1)*tpb), tpb =
// ceil(tiles / nblocks), and writes its kk best (score, row) per query,
// best first, lowest row first among equal scores, to out_v / out_i
// (nblocks, nq, kk) f32 / int32. A row whose score is -inf (or NaN, which
// is taken as -inf) is a candidate like any other and keeps its row number;
// only a block with fewer than kk rows leaves slots, which hold
// (-inf, INT_MAX).
// rows f32, or bf16 when rows_bf16 != 0. 1 <= kk <= min(max_k, n).
int irt_fused_optimized_topk(const void* q, const void* qn, const void* rows, int rows_bf16,
                             const void* mags, void* out_v, void* out_i, int nq, int n, int d,
                             int kk, int nblocks, float w0, float w1, float w2, float w3,
                             float w4, int live, void* stream);

#ifdef __cplusplus
}
#endif

#ifndef IRT_BAD_ARGS
#define IRT_BAD_ARGS 100000
#endif

#ifdef __CUDACC__

#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace fm {

constexpr int kThreads = 128;
constexpr int kRT = 2;                      // rows a thread accumulates: r and r + 32
constexpr int kRows = 32 * kRT;             // rows of a tile: 64
constexpr int kGroups = kThreads / 32;      // query groups, one warp each: 4
constexpr int kQT = 8;                      // queries a thread accumulates
constexpr int kQP = kGroups * kQT;          // queries of one pass: 32
constexpr int kDC = 64;                     // dims staged per step
// Row stride in shared memory, in floats: 68 = 4 mod 32, so the eight
// 16-byte reads of a quarter warp (eight consecutive rows) cover all 32
// banks once.
constexpr int kRStride = kDC + 4;
constexpr int kMaxK = 64;

// Weights of the score and which of them take part (bit t = weight t).
struct Weights {
  float w[5];
  int live;
};

// Sums of the thread's (row, query) pairs.
struct Acc {
  float dot[kRT][kQT];   // <row, q>
  float l1[kRT][kQT];    // sum |u - q|, u the row scaled by its magnitude
  float sq[kRT][kQT];    // sum (u - q)^2
  float linf[kRT][kQT];  // max |u - q|
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// One chunk (kDC dims from d0) of a tile's rows into shared memory as f32;
// rows past the tile and dims past d become zeros. `vec`: 16-byte loads
// (every row start and d0 are 16-byte aligned).
template <typename RowT>
__device__ __forceinline__ void load_rows(float* s_rows, const RowT* tile, int tile_rows, int d,
                                          int d0, bool vec) {
  constexpr int kPer = 16 / (int)sizeof(RowT);  // elements of one 16-byte load
  constexpr int kVecs = kDC / kPer;
  if (vec && d - d0 >= kDC) {
#pragma unroll
    for (int it = 0; it < kRows * kVecs / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kVecs, v = i - r * kVecs;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // all-zero bits are 0 in every row type
      if (r < tile_rows) {
        raw = *reinterpret_cast<const uint4*>(tile + (size_t)r * d + d0 + v * kPer);
      }
      const RowT* e = reinterpret_cast<const RowT*>(&raw);
      float* dst = s_rows + r * kRStride + v * kPer;
#pragma unroll
      for (int j = 0; j < kPer; j += 4) {
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(to_f32(e[j]), to_f32(e[j + 1]), to_f32(e[j + 2]), to_f32(e[j + 3]));
      }
    }
  } else {
    const int cd = min(kDC, d - d0);
    for (int i = threadIdx.x; i < kRows * kDC; i += kThreads) {
      const int r = i / kDC, c = i - r * kDC;
      float v = 0.f;
      if (r < tile_rows && c < cd) v = to_f32(tile[(size_t)r * d + d0 + c]);
      s_rows[r * kRStride + c] = v;
    }
  }
}

// The same chunk of one pass's queries (kQP from q0), zeros past nq and d.
// `vec`: 16-byte loads.
__device__ __forceinline__ void load_queries(float* s_q, const float* q, int q0, int nq, int d,
                                             int d0, bool vec) {
  if (vec && d - d0 >= kDC) {
#pragma unroll
    for (int it = 0; it < kQP * kDC / 4 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int qi = i / (kDC / 4), c = (i - qi * (kDC / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + qi < nq) {
        v = *reinterpret_cast<const float4*>(q + (size_t)(q0 + qi) * d + d0 + c);
      }
      *reinterpret_cast<float4*>(s_q + qi * kDC + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < kQP * kDC; i += kThreads) {
      const int qi = i / kDC, c = i - qi * kDC;
      float v = 0.f;
      if (q0 + qi < nq && d0 + c < d) v = q[(size_t)(q0 + qi) * d + d0 + c];
      s_q[qi * kDC + c] = v;
    }
  }
}

// One staged chunk into the thread's sums: rows r and r + 32 against the
// `qcount` queries of group `grp`. u = row * rowmul, rounded once; the
// difference u - q is rounded before it is used, never contracted into the
// product. Per four
// dims a thread makes one 16-byte read per row and one per query for
// 4 x kRT x kQT products: the reads of shared memory, not the FMAs, would
// limit a thread that held one row. The chunk's products and |u - q| are
// summed on their own and then added to the totals, which keeps these f32
// sums of 512 or 768 terms close to a pairwise sum (the squares go straight
// into their total: the root halves their error). kL1, kLinf and kSq say
// which sums of the difference are taken: one that is not costs no
// instruction. `kFull`: the group has all kQT queries, so nothing in the
// loop is conditional and the compiler is free to interleave the queries'
// reads and sums; a smaller group tests each query.
template <bool kDot, bool kL1, bool kLinf, bool kSq, bool kFull>
__device__ __forceinline__ void accumulate_chunk(const float* s_rows, const float* s_q, int r,
                                                 int grp, int qcount, const float* rowmul,
                                                 Acc& tot) {
  constexpr bool kDiff = kL1 || kLinf || kSq;  // u - q is formed at all
  float dot[kRT][kQT], l1[kRT][kQT];
#pragma unroll
  for (int t = 0; t < kRT; ++t)
#pragma unroll
    for (int j = 0; j < kQT; ++j) dot[t][j] = l1[t][j] = 0.f;
  const float* rowp = s_rows + r * kRStride;
  const float* qp = s_q + grp * kQT * kDC;
#pragma unroll 2
  for (int c = 0; c < kDC; c += 4) {
    float g[kRT][4], u[kRT][4];
#pragma unroll
    for (int t = 0; t < kRT; ++t) {
      const float4 gv = *reinterpret_cast<const float4*>(rowp + t * 32 * kRStride + c);
      g[t][0] = gv.x, g[t][1] = gv.y, g[t][2] = gv.z, g[t][3] = gv.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u[t][e] = kDiff ? __fmul_rn(g[t][e], rowmul[t]) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      if (kFull || j < qcount) {
        const float4 qv = *reinterpret_cast<const float4*>(qp + j * kDC + c);
        const float qe[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int t = 0; t < kRT; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (kDot) dot[t][j] = fmaf(g[t][e], qe[e], dot[t][j]);
            if (kDiff) {
              const float df = __fsub_rn(u[t][e], qe[e]);
              if (kL1) l1[t][j] += fabsf(df);
              if (kLinf) tot.linf[t][j] = fmaxf(tot.linf[t][j], fabsf(df));
              if (kSq) tot.sq[t][j] = fmaf(df, df, tot.sq[t][j]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kRT; ++t) {
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      if (kDot) tot.dot[t][j] += dot[t][j];
      if (kL1) tot.l1[t][j] += l1[t][j];
    }
  }
}

// All of d for one tile: stage, synchronise, accumulate. Every thread of
// the block calls it (it synchronises the block).
template <typename RowT, bool kDot, bool kL1, bool kLinf, bool kSq>
__device__ __forceinline__ void sweep_tile(float* s_rows, float* s_q, const RowT* tile,
                                           int tile_rows, const float* q, int q0, int nq, int d,
                                           bool vec, bool qvec, int r, int grp, int qcount,
                                           const float* rowmul, Acc& tot) {
#pragma unroll
  for (int t = 0; t < kRT; ++t)
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      tot.dot[t][j] = tot.l1[t][j] = tot.sq[t][j] = tot.linf[t][j] = 0.f;
    }
  if constexpr (kDot || kL1 || kLinf || kSq) {
    for (int d0 = 0; d0 < d; d0 += kDC) {
      __syncthreads();  // the previous chunk has been read
      load_rows<RowT>(s_rows, tile, tile_rows, d, d0, vec);
      load_queries(s_q, q, q0, nq, d, d0, qvec);
      __syncthreads();
      if (qcount == kQT) {
        accumulate_chunk<kDot, kL1, kLinf, kSq, true>(s_rows, s_q, r, grp, qcount, rowmul, tot);
      } else if (qcount > 0) {
        accumulate_chunk<kDot, kL1, kLinf, kSq, false>(s_rows, s_q, r, grp, qcount, rowmul, tot);
      }
    }
  }
}

// The epilogue's terms, each one rounded operation after the other in the
// order of the plain versions (ops/metrics.py), so that only the order of
// the sums over d separates a kernel from its plain version.
__device__ __forceinline__ float cosine(float udot, float qn) {
  return qn > 0.f ? __fdiv_rn(udot, qn) : 0.f;
}

__device__ __forceinline__ float l1_term(float l1_sum, int d) {
  return __fdiv_rn(l1_sum, (float)d);
}

__device__ __forceinline__ float l2_term(float sq, int d) {
  return __fdiv_rn(sqrtf(sq), sqrtf((float)d));
}

// ||m g - q||^2 = m^2 - 2 m <g, q> + ||q||^2 for a unit row g, clamped at 0.
__device__ __forceinline__ float gram_sq(float m, float udot, float qn) {
  const float t = __fsub_rn(__fmul_rn(m, m), __fmul_rn(__fmul_rn(2.f, m), udot));
  return fmaxf(__fadd_rn(t, __fmul_rn(qn, qn)), 0.f);
}

__device__ __forceinline__ float mag_term(float m, float qn) { return fabsf(__fsub_rn(m, qn)); }

// The weighted score of one (row, query) from its sums, udot = <unit row, q>:
// w0*cos - w1*L1 - w2*L2 - w3*Linf - w4*dmag over the live terms, L2 in the
// Gram form. The f32 scorer subtracts L1, Linf, L2 in that order, the int8
// scorer L2, L1, Linf. A term that is not live is not computed.
template <bool kInt8>
__device__ __forceinline__ float weighted(const Weights& w, float udot, float l1_sum, float linf,
                                          float m, float qn, int d) {
  float t = 0.f;
  if (w.live & 1) t = __fadd_rn(t, __fmul_rn(w.w[0], cosine(udot, qn)));
  if (kInt8 && (w.live & 4)) {
    t = __fsub_rn(t, __fmul_rn(w.w[2], l2_term(gram_sq(m, udot, qn), d)));
  }
  if (w.live & 2) t = __fsub_rn(t, __fmul_rn(w.w[1], l1_term(l1_sum, d)));
  if (w.live & 8) t = __fsub_rn(t, __fmul_rn(w.w[3], linf));
  if (!kInt8 && (w.live & 4)) {
    t = __fsub_rn(t, __fmul_rn(w.w[2], l2_term(gram_sq(m, udot, qn), d)));
  }
  if (w.live & 16) t = __fsub_rn(t, __fmul_rn(w.w[4], mag_term(m, qn)));
  return t;
}

}  // namespace fm

#endif  // __CUDACC__
