// The fused metric kernels for Hopper (fused_metrics.cu): their plain C
// interface, bound from Python with ctypes
// (image_retrieval_tpu_torch/ops/_build.py), and, for CUDA translation
// units, the device code they share: the weights and the epilogue that turns
// a (row, query)'s sums into metric planes or a weighted score. K4, K6 and
// K7 sweep the rows in f32_sweep_sm90.cuh, K5 in int8_sweep_sm90.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

// All kernels: q (nq, d) f32 queries, unnormalized; qn (nq,) f32 their
// norms; mags (n,) f32 stored magnitudes; rows (n, d) unit rows, row-major
// and contiguous; outputs row-major; everything on the current device and
// enqueued on `stream`. K4, K6, K7: qpad is null exactly where
// irt_f32_sweep_plan keeps the queries resident (IRT_BAD_ARGS otherwise),
// else the queries zero-padded to (nq rounded up to 8, q_pitch) f32. Each returns cudaGetLastError() of its launch
// (0 = ok) or IRT_BAD_ARGS.

// K6. out (5, nq, n) f32: cosine (0 for a zero-norm query), L1/d, direct
// L2/sqrt(d), Linf and |mag - ||q||| of the rows scaled by their magnitudes.
// rows f32.
int irt_fused_all_metrics(const void* q, const void* qn, const void* qpad, const void* rows,
                          const void* mags, void* out, int nq, int n, int d, void* stream);

// K7. out (nq, n) f32 = w0*cos - w1*L1 - w2*L2 - w3*Linf - w4*dmag with the
// Gram-form L2; weights: 5 f32 on the device, read when the kernel runs, so
// no term is ever skipped. rows f32.
int irt_fused_optimized_scores(const void* q, const void* qn, const void* qpad,
                               const void* weights, const void* rows, const void* mags, void* out,
                               int nq, int n, int d, void* stream);

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
// inside the kernel: each consumer warp keeps the best kk (score, row) of
// its queries over the rows it sweeps, best first, lowest row first among
// equal scores, and writes them as candidate list blockIdx.x * row units +
// its row unit to out_v / out_i (lists, nq, kk) f32 / int32; `lists` must be
// irt_f32_sweep_plan's (IRT_BAD_ARGS otherwise). A row whose score is -inf (or NaN, which is taken as
// -inf) is a candidate like any other and keeps its row number; only a list
// that saw fewer than kk rows leaves slots, which hold (-inf, INT_MAX).
// rows f32, or bf16 when rows_bf16 != 0. 1 <= kk <= min(max_k, n).
int irt_fused_optimized_topk(const void* q, const void* qn, const void* qpad, const void* rows,
                             int rows_bf16, const void* mags, void* out_v, void* out_i, int nq,
                             int n, int d, int kk, int lists, float w0, float w1, float w2,
                             float w3, float w4, int live, void* stream);

// The sweep of K4, K6 and K7 for (nq, n, d) with rows of row_bytes (4: f32,
// 2: bf16), live weight bits `live` and kk (0 for K6 and K7) on a card of
// `sms` SMs, `aligned` (the rows' base is 16-byte aligned): 0 and out[17] =
// (qw, groups, tile_rows, passes, resident, q_rows, q_pitch, box_dims,
// boxes, stage_boxes, stages, stage_bytes, tma, tiles, grid, lists, smem), or
// IRT_BAD_ARGS for a shape the kernels refuse.
int irt_f32_sweep_plan(int nq, int n, int d, int row_bytes, int live, int kk, int aligned,
                       int sms, int* out);

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

constexpr int kMaxK = 64;

// Weights of the score and which of them take part (bit t = weight t).
struct Weights {
  float w[5];
  int live;
};

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
