// Device code shared by the Hopper (sm_90a) transformer-layer kernels that
// keep their projections in the compute type (bf16 or f32, no quantization):
// layer_block.cu (whole layer, K8), attention_block.cu and mlp_block.cu (its
// two halves, K9a and K9b) and attention_block_train.cu (K11).
// multihead_attention.cu needs attention_sm90.cuh alone. Each is a chain of
// kernels, every one reading its operands once from device memory (the 50
// MB L2 holds a layer's weights and activations between launches):
//   (a) ln_cast_kernel          LayerNorm (f32, fast variance) cast to the
//                               compute type; a warp per row, eight rows a
//                               block, the row in registers up to 1,024
//                               values (read twice beyond), its sums in
//                               the order of the block a row it replaced.
//   (b) gemm_persistent_kernel  bf16 GEMM on the tensor cores
//                               (gemm_sm90.cuh: persistent blocks over tiles
//                               of 128 columns and 64-192 rows, wgmma
//                               m64n128k16 with f32 sums fed by TMA, the
//                               outputs stored by TMA from shared memory
//                               under the next tile's products).
//       gemm_f32_kernel         f32 GEMM on the CUDA cores: every product an
//                               exact f32 FMA (never TF32), one accumulator
//                               per output over ascending k. Slow, and only
//                               the f32 compute type takes it.
//       Both end in one fused epilogue: acc + bias in f32, then the cast, or
//       quick_gelu in f32 and the cast, or the cast and the residual add in
//       the compute type.
//   (c) the attention of attention_sm90.cuh (bf16: attention_wgmma_kernel
//       or attention_tiled_mma_kernel on the tensor cores; f32:
//       attention_tiled_kernel), on packed
//       [q | k | v] rows.
//
// Numerics follow the JAX kernels (_layer_block_kernel, _attn_block_kernel,
// _mlp_block_kernel): the LayerNorm output is cast to the compute type
// before the projection; q, k and v are f32 sums that hold the bias, each
// cast once; projection outputs are cast before the residual add, which is
// taken in the compute type; fc1 stays f32 through quick_gelu and is cast
// after it; attention scales after the QK dot in f32.
#pragma once

#include <type_traits>

#include "block_common.cuh"
#include "gemm_sm90.cuh"
#include "attention_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// (a) LayerNorm cast to the compute type
// ---------------------------------------------------------------------------

constexpr int kLnWarps = 8;  // rows of a block
// the widest row the chains take
constexpr int kMaxLnWidth = 48 * 1024 / (int)sizeof(float);

// A warp per row of `width` values:
// T((x - mu) * rsqrt(max(E[x^2] - mu^2, 0) + 1e-5) * gamma + beta). The sums
// keep the order of a block of 256 threads, one a row element in turn: the
// warp stands for eight warps of such a block, lane l for threads t = 32 v
// + l (v = 0-7), each adding x[t], x[t + 256], ... in order (the squares by
// fmaf); each group of 32 partials is reduced by warp_sum, then the eight
// by warp_sum over lanes 0-7 (block_sum's order). The statistics, and so
// every output, are those of that block, whatever the width, and every
// chain's pass sums in one order. A warp's loads and stores are 32
// neighbouring values. kPer: the values a lane holds in registers (per
// virtual thread 1-4; rows of up to 1,024); 0 reads a wider row twice, once
// for its sums and once to normalise it.
constexpr int kLnBlockWarps = 8;  // warps of the block whose order the sums keep

template <typename T, int kPer>
__global__ void __launch_bounds__(kLnWarps * 32) ln_cast_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    T* __restrict__ h, int m, int width) {
  constexpr int kStride = 32 * kLnBlockWarps;  // 256: one pass of the block over the row
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (row >= m) return;
  const T* xr = x + (size_t)row * width;
  T* hr = h + (size_t)row * width;
  float v[kLnBlockWarps][kPer > 0 ? kPer : 1];
  float part_sum[kLnBlockWarps], part_sq[kLnBlockWarps];
#pragma unroll
  for (int u = 0; u < kLnBlockWarps; ++u) {
    float sum = 0.f, sq = 0.f;
    if constexpr (kPer > 0) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = 32 * u + lane + kStride * i;
        v[u][i] = e < width ? to_f32(xr[e]) : 0.f;
        if (e < width) {
          sum += v[u][i];
          sq = fmaf(v[u][i], v[u][i], sq);
        }
      }
    } else {
      for (int e = 32 * u + lane; e < width; e += kStride) {
        const float a = to_f32(xr[e]);
        sum += a;
        sq = fmaf(a, a, sq);
      }
    }
    part_sum[u] = warp_sum(sum);
    part_sq[u] = warp_sum(sq);
  }
  float sum = 0.f, sq = 0.f;  // lane u < 8 takes the partials of virtual warp u
#pragma unroll
  for (int u = 0; u < kLnBlockWarps; ++u) {
    if (lane == u) {
      sum = part_sum[u];
      sq = part_sq[u];
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = __fdiv_rn(sum, (float)width);
  const float ms = __fdiv_rn(sq, (float)width);
  const float var = fmaxf(__fsub_rn(ms, __fmul_rn(mu, mu)), 0.f);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, 1e-5f)));
  auto norm = [&](int e, float a) {
    const float y = __fmul_rn(__fmul_rn(__fsub_rn(a, mu), inv), gamma[e]);
    hr[e] = from_f32<T>(__fadd_rn(y, beta[e]));
  };
#pragma unroll
  for (int u = 0; u < kLnBlockWarps; ++u) {
    if constexpr (kPer > 0) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = 32 * u + lane + kStride * i;
        if (e < width) norm(e, v[u][i]);
      }
    } else {
      for (int e = 32 * u + lane; e < width; e += kStride) norm(e, to_f32(xr[e]));
    }
  }
}

// ---------------------------------------------------------------------------
// (b) GEMMs with the fused epilogue
// ---------------------------------------------------------------------------

enum DenseEpilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

// One output value from its f32 sum: + bias, then by kEpi. `res` is the
// residual stream's value at the same place (kBiasResidual only).
template <typename T, int kEpi>
__device__ __forceinline__ float finish(float acc, float bias, float res) {
  float v = __fadd_rn(acc, bias);
  if (kEpi == kBiasGelu) {  // quick_gelu in f32: v * sigmoid(1.702 v), cast after
    const float z = __fmul_rn(1.702f, v);
    return __fmul_rn(v, __frcp_rn(__fadd_rn(1.f, expf(-z))));
  }
  if (kEpi == kBiasResidual) {  // cast, then add in the compute type
    return __fadd_rn(res, round_to<T>(v));
  }
  return v;
}

// ---- bf16 on the tensor cores (gemm_sm90.cuh) ------------------------------

// The epilogue of the bf16 GEMM (gemm_persistent_kernel): one output from
// its f32 sum by finish<bf16, kEpi>, the bias being the tile's one staged
// column parameter and the residual read by TMA; the kernel casts it to
// bf16 and stores its tile by TMA.
template <int kEpi>
struct DenseEpilogueBf16 {
  typedef __nv_bfloat16 Out;
  static constexpr int kColParams = 1;  // bias
  static constexpr bool kRowScale = false;
  static constexpr bool kAddsResidual = kEpi == kBiasResidual;
  const float* bias;
  int m, n;
  __device__ __forceinline__ const float* col_param(int) const { return bias; }
  __device__ __forceinline__ float operator()(float acc, float, float b, float,
                                              float res) const {
    return finish<__nv_bfloat16, kEpi>(acc, b, res);
  }
};

// ---- f32 on the CUDA cores -------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16;
constexpr int FLD = FBM + 4;  // rows of 68 floats stay 16-byte aligned
constexpr int kF32GemmThreads = 256;  // 16 x 16 threads, each a 4 x 4 tile

// The same function in f32: A (M, K), Bt (N, K), N % 64 == 0, K % 16 == 0.
// Each output is one chain of fmaf over ascending k.
template <int kEpi>
__global__ void __launch_bounds__(kF32GemmThreads) gemm_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ Bt, const float* __restrict__ bias,
    const float* __restrict__ residual, float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[FBK][FLD];  // k-major: a thread reads 4 rows at once
  __shared__ __align__(16) float Bs[FBK][FLD];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int lr = tid >> 2, lc = (tid & 3) * 4;  // the 4 values of a tile this thread loads
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + lr < M) a = *reinterpret_cast<const float4*>(A + (size_t)(m0 + lr) * K + k0 + lc);
    const float4 b = *reinterpret_cast<const float4*>(Bt + (size_t)(n0 + lr) * K + k0 + lc);
    As[lc][lr] = a.x, As[lc + 1][lr] = a.y, As[lc + 2][lr] = a.z, As[lc + 3][lr] = a.w;
    Bs[lc][lr] = b.x, Bs[lc + 1][lr] = b.y, Bs[lc + 2][lr] = b.z, Bs[lc + 3][lr] = b.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      const size_t o = (size_t)m * N + n;
      const float res = kEpi == kBiasResidual ? residual[o] : 0.f;
      C[o] = finish<float, kEpi>(acc[i][j], bias[n], res);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename T>
int launch_ln_cast(const T* x, const float* gamma, const float* beta, T* h, int m, int width,
                   cudaStream_t st) {
  const dim3 grid((m + kLnWarps - 1) / kLnWarps);
  // the values of a virtual thread, 256 apart: 1-4 held in registers, or
  // the row read twice past 1,024
  const int per = width > 1024 ? 0 : (width + 255) / 256;
#define IRT_LN(P) \
  IRT_TRY(ln_cast_kernel<T, P><<<grid, kLnWarps * 32, 0, st>>>(x, gamma, beta, h, m, width))
  switch (per) {
    case 1:
      IRT_LN(1);
      break;
    case 2:
      IRT_LN(2);
      break;
    case 3:
      IRT_LN(3);
      break;
    case 4:
      IRT_LN(4);
      break;
    default:
      IRT_LN(0);
  }
#undef IRT_LN
  return 0;
}

template <typename T, int kEpi>
int launch_gemm(const T* a, const T* bt, const float* bias, const T* residual, T* c, int m,
                int n, int k, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    IRT_TRY(gemm_f32_kernel<kEpi><<<dim3(n / FBN, (m + FBM - 1) / FBM), kF32GemmThreads, 0, st>>>(
        a, bt, bias, residual, c, m, n, k));
  } else {
    return launch_gemm_tc<__nv_bfloat16>(a, bt, residual, c, k,
                                          DenseEpilogueBf16<kEpi>{bias, m, n}, st);
  }
  return 0;
}

// The attention sub-block: LN1 -> cast -> QKV (+ bias, cast) -> attention ->
// out-projection (+ bias, cast) -> x + out. Four launches. The training
// entry hands in tensors of its own for qkv and attn, which it keeps, and a
// plane for the f32 probabilities.
struct DenseAttnWorkspace {
  void* h;     // (m, width)   LN1 rows, compute type
  void* qkv;   // (m, 3 width)
  void* attn;  // (m, width)
  float* probs = nullptr;  // (batch, heads, seq, seq) f32, or none
};

inline void carve_dense_attn(Carver& c, int m, int width, int eb, DenseAttnWorkspace* w) {
  const size_t mw = (size_t)m * width;
  w->h = c.take(mw * eb);
  w->qkv = c.take(3 * mw * eb);
  w->attn = c.take(mw * eb);
}

template <typename T>
int run_dense_attn_block(const T* x, T* out, const float* ln_s, const float* ln_b,
                         const T* wqkv_t, const float* bqkv, const T* wo_t, const float* bo,
                         const DenseAttnWorkspace& w, int batch, int seq, int width, int heads,
                         int causal, float scale, cudaStream_t st) {
  const int m = batch * seq;
  T* h = (T*)w.h;
  T* qkv = (T*)w.qkv;
  T* attn = (T*)w.attn;
  IRT_CHECK(launch_ln_cast<T>(x, ln_s, ln_b, h, m, width, st));
  IRT_CHECK((launch_gemm<T, kBias>(h, wqkv_t, bqkv, nullptr, qkv, m, 3 * width, width, st)));
  IRT_CHECK(launch_attention_packed<T>(qkv, attn, batch, seq, width, heads, causal, scale, st,
                                       w.probs));
  IRT_CHECK((launch_gemm<T, kBiasResidual>(attn, wo_t, bo, x, out, m, width, width, st)));
  return 0;
}

// The MLP sub-block: LN2 -> cast -> fc1 (+ bias, f32) -> quick_gelu in f32 ->
// cast -> fc2 (+ bias, cast) -> x + out. Three launches.
struct DenseMlpWorkspace {
  void* h;  // (m, width)  LN2 rows, compute type
  void* a;  // (m, hidden) quick_gelu(fc1), compute type
};

inline void carve_dense_mlp(Carver& c, int m, int width, int hidden, int eb,
                            DenseMlpWorkspace* w) {
  w->h = c.take((size_t)m * width * eb);
  w->a = c.take((size_t)m * hidden * eb);
}

template <typename T>
int run_dense_mlp_block(const T* x, T* out, const float* ln_s, const float* ln_b, const T* w1_t,
                        const float* b1, const T* w2_t, const float* b2,
                        const DenseMlpWorkspace& w, int m, int width, int hidden,
                        cudaStream_t st) {
  T* h = (T*)w.h;
  T* a = (T*)w.a;
  IRT_CHECK(launch_ln_cast<T>(x, ln_s, ln_b, h, m, width, st));
  IRT_CHECK((launch_gemm<T, kBiasGelu>(h, w1_t, b1, nullptr, a, m, hidden, width, st)));
  IRT_CHECK((launch_gemm<T, kBiasResidual>(a, w2_t, b2, x, out, m, width, hidden, st)));
  return 0;
}

inline bool dense_shape_ok(int batch, int seq, int width, int hidden, int dtype) {
  return batch > 0 && seq > 0 && width > 0 && width % 64 == 0 && hidden > 0 &&
         hidden % 64 == 0 && width <= kMaxLnWidth && (dtype == 0 || dtype == 1) &&
         rows_ok((long long)batch * seq);
}

}  // namespace
