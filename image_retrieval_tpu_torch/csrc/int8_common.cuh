// Device code shared by the Hopper (sm_90a) int8 serving kernels:
// layer_block_int8.cu (whole layer), attention_block_int8.cu and
// mlp_block_int8.cu (its two halves) and quant_dense.cu (one projection).
// Each is a chain of these simple kernels, every one reading its operands
// once from device memory (the 50 MB L2 holds a layer's weights and
// activations between launches):
//   (a) ln_rowquant_kernel      LayerNorm (f32, fast variance) fused with the
//                               per-row int8 quantization; one block per row.
//   (b) gemm_wgmma_s8_kernel    int8 GEMM on the tensor cores
//                               (gemm_sm90.cuh: wgmma m64n128k32 with int32
//                               sums fed by TMA through a shared-memory
//                               ring, tiles of 128 columns and 256, 128 or
//                               64 rows) and a fused epilogue:
//                               acc * row_scale * col_scale + bias,
//                               then quick_gelu in f32 or the residual add in
//                               the compute type.
//   (c) the attention of block_common.cuh (bf16: attention_tiled_mma_kernel
//       on the tensor cores; f32: attention_tiled_kernel), on packed
//       [q | k | v] rows.
// Everything sits in an anonymous namespace: each source that includes this
// file gets its own copy and instantiates only the kernels it launches.
//
// Numerics follow the JAX kernels: rowquant is round-half-even of a true
// division (__fdiv_rn, __float2int_rn); the dequant keeps the order
// acc * hs * ws + b with no contraction into an FMA (__fmul_rn/__fadd_rn);
// projection outputs are cast to the compute type before the residual add,
// while fc1 stays f32 through quick_gelu; attention scales after the QK dot
// in f32. Built without --use_fast_math.
#pragma once

#include "block_common.cuh"
#include "gemm_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// (a) LayerNorm + per-row int8 quantization
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;
// a row of f32 values sits in dynamic shared memory; the default limit
constexpr int kMaxRowWidth = 48 * 1024 / (int)sizeof(float);

// One block per row of `width` values. With kLN, the row is first
// normalized: (x - mu) * rsqrt(E[x^2] - mu^2 (>= 0) + 1e-5) * gamma + beta.
// Then s = max(absmax, 1e-12) / 127 and q = round_half_even(h / s).
template <typename In, bool kLN>
__global__ void __launch_bounds__(kRowThreads) ln_rowquant_kernel(
    const In* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, int8_t* __restrict__ q,
    float* __restrict__ qscale, int width) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * width;
  float sum = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const float v = to_f32(x[base + i]);
    row[i] = v;  // each thread later reads back only its own elements
    if (kLN) {
      sum += v;
      sq = fmaf(v, v, sq);
    }
  }
  if (kLN) {
    sum = block_sum(sum, red);
    sq = block_sum(sq, red);
    const float mu = __fdiv_rn(sum, (float)width);
    const float ms = __fdiv_rn(sq, (float)width);
    const float var = fmaxf(__fsub_rn(ms, __fmul_rn(mu, mu)), 0.f);
    const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, 1e-5f)));
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
      const float h = __fmul_rn(__fmul_rn(__fsub_rn(row[i], mu), inv), gamma[i]);
      row[i] = __fadd_rn(h, beta[i]);
    }
  }
  float amax = 0.f;
  for (int i = threadIdx.x; i < width; i += blockDim.x) amax = fmaxf(amax, fabsf(row[i]));
  amax = block_max(amax, red);
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    q[base + i] = (int8_t)__float2int_rn(__fdiv_rn(row[i], s));
  }
  if (threadIdx.x == 0) qscale[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// (b) int8 GEMM with fused dequant epilogue
// ---------------------------------------------------------------------------

enum Epilogue { kStore = 0, kGelu = 1, kResidual = 2 };

// The epilogue of the int8 GEMM (gemm_sm90.cuh): two neighbouring outputs of
// one row from their int32 sums, acc * row_scale * col_scale + bias in f32,
// then quick_gelu in f32, or the cast and the residual add in the compute
// type; one 4-byte (bf16) or 8-byte (f32) store.
template <typename OutT, int kEpi>
struct Int8Epilogue {
  const float* row_scale;
  const float* col_scale;
  const float* bias;
  const OutT* residual;  // kResidual only
  OutT* c;
  int m, n;
  __device__ __forceinline__ float finish(int acc, float rs, int col, size_t o) const {
    float v = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), col_scale[col]), bias[col]);
    if (kEpi == kGelu) {  // quick_gelu in f32: v * sigmoid(1.702 v)
      const float z = __fmul_rn(1.702f, v);
      v = __fmul_rn(v, __frcp_rn(__fadd_rn(1.f, expf(-z))));
    } else if (kEpi == kResidual) {  // cast, then add in the compute type
      v = __fadd_rn(to_f32(residual[o]), round_to<OutT>(v));
    }
    return v;
  }
  __device__ __forceinline__ void operator()(int row, int col, int a0, int a1) const {
    const size_t o = (size_t)row * n + col;
    const float rs = row_scale[row];
    store_pair(c + o, finish(a0, rs, col, o), finish(a1, rs, col + 1, o + 1));
  }
};

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename In, bool kLN>
int launch_ln_rowquant(const In* x, const float* gamma, const float* beta, int8_t* q,
                       float* qscale, int m, int width, cudaStream_t st) {
  IRT_TRY(ln_rowquant_kernel<In, kLN><<<m, kRowThreads, width * sizeof(float), st>>>(
      x, gamma, beta, q, qscale, width));
  return 0;
}

template <typename OutT, int kEpi>
int launch_gemm_s8(const int8_t* a, const int8_t* bt, const float* row_scale,
                   const float* col_scale, const float* bias, const OutT* residual,
                   OutT* c, int m, int n, int k, cudaStream_t st) {
  return launch_gemm_wgmma<int8_t>(
      a, bt, k, Int8Epilogue<OutT, kEpi>{row_scale, col_scale, bias, residual, c, m, n}, st);
}

// The attention sub-block: LN1 -> rowquant -> int8 QKV -> attention ->
// rowquant -> int8 out-proj -> x + out. Five launches.
struct AttnWorkspace {
  int8_t* hq;  // (m, width)   LN1 rows, int8
  float* hs;   // (m,)
  void* qkv;   // (m, 3 width) compute type
  void* attn;  // (m, width)   compute type
  int8_t* aq;  // (m, width)
  float* as;   // (m,)
};

inline void carve_attn(Carver& c, int m, int width, int eb, AttnWorkspace* w) {
  const size_t mw = (size_t)m * width;
  w->hq = (int8_t*)c.take(mw);
  w->hs = (float*)c.take(m * sizeof(float));
  w->qkv = c.take(3 * mw * eb);
  w->attn = c.take(mw * eb);
  w->aq = (int8_t*)c.take(mw);
  w->as = (float*)c.take(m * sizeof(float));
}

template <typename T>
int run_attn_block(const T* x, T* out, const float* ln_s, const float* ln_b,
                   const int8_t* wqkv_t, const float* wqkv_s, const float* bqkv,
                   const int8_t* wo_t, const float* wo_s, const float* bo,
                   const AttnWorkspace& w, int batch, int seq, int width, int heads,
                   int causal, float scale, cudaStream_t st) {
  const int m = batch * seq;
  T* qkv = (T*)w.qkv;
  T* attn = (T*)w.attn;
  IRT_CHECK((launch_ln_rowquant<T, true>(x, ln_s, ln_b, w.hq, w.hs, m, width, st)));
  IRT_CHECK((launch_gemm_s8<T, kStore>(w.hq, wqkv_t, w.hs, wqkv_s, bqkv, nullptr, qkv, m,
                                       3 * width, width, st)));
  IRT_CHECK(launch_attention_packed<T>(qkv, attn, batch, seq, width, heads, causal, scale, st));
  IRT_CHECK((launch_ln_rowquant<T, false>(attn, nullptr, nullptr, w.aq, w.as, m, width, st)));
  IRT_CHECK((launch_gemm_s8<T, kResidual>(w.aq, wo_t, w.as, wo_s, bo, x, out, m, width,
                                          width, st)));
  return 0;
}

// The MLP sub-block: LN2 -> rowquant -> int8 fc1 (f32) -> quick_gelu in f32
// -> rowquant -> int8 fc2 -> x + out. Four launches.
struct MlpWorkspace {
  int8_t* hq;  // (m, width)  LN2 rows, int8
  float* hs;   // (m,)
  float* g;    // (m, hidden) f32 quick_gelu(fc1)
  int8_t* gq;  // (m, hidden)
  float* gs;   // (m,)
};

inline void carve_mlp(Carver& c, int m, int width, int hidden, MlpWorkspace* w) {
  const size_t mw = (size_t)m * width, mh = (size_t)m * hidden;
  w->hq = (int8_t*)c.take(mw);
  w->hs = (float*)c.take(m * sizeof(float));
  w->g = (float*)c.take(mh * sizeof(float));
  w->gq = (int8_t*)c.take(mh);
  w->gs = (float*)c.take(m * sizeof(float));
}

template <typename T>
int run_mlp_block(const T* x, T* out, const float* ln_s, const float* ln_b,
                  const int8_t* w1_t, const float* w1_s, const float* b1,
                  const int8_t* w2_t, const float* w2_s, const float* b2,
                  const MlpWorkspace& w, int m, int width, int hidden, cudaStream_t st) {
  IRT_CHECK((launch_ln_rowquant<T, true>(x, ln_s, ln_b, w.hq, w.hs, m, width, st)));
  IRT_CHECK((launch_gemm_s8<float, kGelu>(w.hq, w1_t, w.hs, w1_s, b1, nullptr, w.g, m, hidden,
                                          width, st)));
  IRT_CHECK((launch_ln_rowquant<float, false>(w.g, nullptr, nullptr, w.gq, w.gs, m, hidden, st)));
  IRT_CHECK((launch_gemm_s8<T, kResidual>(w.gq, w2_t, w.gs, w2_s, b2, x, out, m, width, hidden,
                                          st)));
  return 0;
}

inline bool block_shape_ok(int batch, int seq, int width, int hidden, int dtype) {
  return batch > 0 && seq > 0 && width > 0 && width % 64 == 0 && hidden > 0 &&
         hidden % 64 == 0 && width <= kMaxRowWidth && hidden <= kMaxRowWidth &&
         (dtype == 0 || dtype == 1) && rows_ok((long long)batch * seq);
}

}  // namespace
