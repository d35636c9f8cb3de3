// Device code shared by the Hopper (sm_90a) int8 serving kernels:
// layer_block_int8.cu (whole layer), attention_block_int8.cu and
// mlp_block_int8.cu (its two halves) and quant_dense.cu (one projection).
// Each is a chain of these simple kernels, every one reading its operands
// once from device memory (the 50 MB L2 holds a layer's weights and
// activations between launches):
//   (a) ln_rowquant_kernel      LayerNorm (f32, fast variance) fused with the
//                               per-row int8 quantization; one block per row.
//   (b) gemm_s8_kernel          int8 GEMM on the tensor cores (mma.sync
//                               m16n8k32, int32 accumulate), 64x64 tiles,
//                               cp.async double buffering, and a fused
//                               epilogue: acc * row_scale * col_scale + bias,
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

constexpr int BM = 64, BN = 64, BK = 64;
// 80-byte shared rows: the 8 rows a fragment load touches land on distinct
// banks (row * 20 words mod 32 = 0, 20, 8, 28, 16, 4, 24, 12), and rows
// stay 16-byte aligned for cp.async.
constexpr int LDS = BK + 16;
constexpr int kGemmThreads = 128;  // 4 warps, 2 x 2, each a 32 x 32 tile

enum Epilogue { kStore = 0, kGelu = 1, kResidual = 2 };


// D = A(16x32 s8, row) * B(32x8 s8, col) + D, int32.
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// C[m, n] = epilogue(sum_k A[m, k] * Bt[n, k]). A (M, K) int8 row-major,
// Bt (N, K) int8 (output-major weights). N % 64 == 0, K % 64 == 0; rows
// past M are zero-filled on load and not stored.
template <typename OutT, int kEpi>
__global__ void __launch_bounds__(kGemmThreads) gemm_s8_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
    const float* __restrict__ row_scale, const float* __restrict__ col_scale,
    const float* __restrict__ bias, const OutT* __restrict__ residual,
    OutT* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kGemmThreads;  // 256 chunks of 16 bytes per tile
      const int r = c >> 2, col = (c & 3) * 16;
      const int gm = m0 + r;
      const bool in = gm < M;
      cp_async16(&As[stage][r][col], A + (size_t)(in ? gm : 0) * K + k0 + col, in ? 16 : 0);
      cp_async16(&Bs[stage][r][col], Bt + (size_t)(n0 + r) * K + k0 + col, 16);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int kt_count = K / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_count) {
      load_tile(st ^ 1, (kt + 1) * BK);  // stage st^1 was released by the
      cp_async_commit();                 // barrier ending iteration kt-1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = lds32(&As[st][r][kk + tig * 4]);
        af[mi][1] = lds32(&As[st][r + 8][kk + tig * 4]);
        af[mi][2] = lds32(&As[st][r][kk + 16 + tig * 4]);
        af[mi][3] = lds32(&As[st][r + 8][kk + 16 + tig * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        bf[ni][0] = lds32(&Bs[st][n][kk + tig * 4]);
        bf[ni][1] = lds32(&Bs[st][n][kk + 16 + tig * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Accumulator fragment: element e sits at row g + 8 * (e >> 1), column
  // 2 * tig + (e & 1) of its 16 x 8 tile.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + half * 8;
      if (m >= M) continue;
      const float rs = row_scale[m];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn + ni * 8 + tig * 2 + j;
          const size_t o = (size_t)m * N + n;
          float v = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + j]), rs), col_scale[n]),
              bias[n]);
          if (kEpi == kGelu) {  // quick_gelu in f32: v * sigmoid(1.702 v)
            const float z = __fmul_rn(1.702f, v);
            v = __fmul_rn(v, __frcp_rn(__fadd_rn(1.f, expf(-z))));
            C[o] = from_f32<OutT>(v);
          } else if (kEpi == kResidual) {  // cast, then add in the compute type
            C[o] = from_f32<OutT>(__fadd_rn(to_f32(residual[o]), round_to<OutT>(v)));
          } else {
            C[o] = from_f32<OutT>(v);
          }
        }
      }
    }
  }
}

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
  IRT_TRY(gemm_s8_kernel<OutT, kEpi><<<dim3(n / BN, (m + BM - 1) / BM), kGemmThreads, 0, st>>>(
      a, bt, row_scale, col_scale, bias, residual, c, m, n, k));
  return 0;
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
