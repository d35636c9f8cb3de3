// Hopper (sm_90a) int8 whole-layer serving kernel chain.
//
// Replaces the TPU kernel image_retrieval_tpu/ops/flash_attention.py
// _layer_block_int8_kernel (l.772, called at l.855 through
// _pallas_layer_block_int8 and layer_block_int8, l.879): one pre-LN CLIP
// transformer layer with int8 x int8 -> int32 projections.
//
// What bounds it on this card. One ViT-B/32 layer reads ~7 MB of int8
// weights (12 W^2 bytes) and, at batch 8, 400 tokens of activations: about
// 5.7 G int8 operations against ~2 us of weight traffic at 3.35 TB/s, so at
// serving batches the four GEMMs are bound by tensor-core issue, and at
// small batches by launch latency and the serial chain of nine launches.
// The TPU design (all layer weights resident in VMEM across the image grid)
// does not transfer: 7 MB is ~30x one SM's 227 KB of shared memory.
//
// What the design does about it. A chain of simple kernels, each reading
// its operands once from device memory (the 50 MB L2 holds a layer's
// weights and activations between launches):
//   (a) ln_rowquant_kernel   LayerNorm (f32, fast variance) fused with the
//                            per-row int8 quantization; one block per row.
//   (b) gemm_s8_kernel       int8 GEMM on the tensor cores (mma.sync
//                            m16n8k32, int32 accumulate), 64x64 tiles,
//                            cp.async double buffering, and a fused
//                            epilogue: acc * row_scale * col_scale + bias,
//                            then quick_gelu in f32 or the residual add in
//                            the compute type.
//   (c) attention_kernel     one block per (image, head): q, k, v and the
//                            T x T f32 scores stay in shared memory
//                            (T <= 77, head_dim 64: 84 KB), f32 softmax,
//                            probabilities cast to the compute type, PV
//                            accumulated in f32.
// Making it fast (wgmma, TMA, fusing the chain) is later work; this version
// is written to be right first.
//
// Numerics follow the JAX kernel: rowquant is round-half-even of a true
// division (__fdiv_rn, __float2int_rn); the dequant keeps the order
// acc * hs * ws + b with no contraction into an FMA (__fmul_rn/__fadd_rn);
// projection outputs are cast to the compute type before the residual add,
// while fc1 stays f32 through quick_gelu; attention scales after the QK dot
// in f32. Built without --use_fast_math.

#include "layer_block_int8.cuh"

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Type helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

// A cast to the compute type and back (JAX's .astype(dt) on an f32 value).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; every thread gets the result. `red` holds one
// value per warp; the leading barrier protects it across successive calls.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

// ---------------------------------------------------------------------------
// (a) LayerNorm + per-row int8 quantization
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src_bytes = 0 zero-fills the 16 bytes (rows past M)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
// (c) Per-(image, head) attention in shared memory
// ---------------------------------------------------------------------------

constexpr int kAttnThreads = 256;

// qkv: (batch * seq, 3 * width) rows [q | k | v], heads contiguous inside
// each. out: (batch * seq, width). Grid (heads, batch).
template <typename T>
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(
    const T* __restrict__ qkv, T* __restrict__ out, int seq, int width, int head_dim,
    int causal, float scale) {
  extern __shared__ float sm[];
  const int ld = head_dim + 1;  // odd stride: column walks hit distinct banks
  const int lds = seq + 1;
  float* qs = sm;
  float* ks = qs + seq * ld;
  float* vs = ks + seq * ld;
  float* ps = vs + seq * ld;  // seq x lds scores, then probabilities
  const int h = blockIdx.x;
  const size_t row0 = (size_t)blockIdx.y * seq;

  for (int idx = threadIdx.x; idx < seq * head_dim; idx += blockDim.x) {
    const int t = idx / head_dim, d = idx - t * head_dim;
    const T* src = qkv + (row0 + t) * (size_t)(3 * width) + h * head_dim + d;
    qs[t * ld + d] = to_f32(src[0]);
    ks[t * ld + d] = to_f32(src[width]);
    vs[t * ld + d] = to_f32(src[2 * width]);
  }
  __syncthreads();

  // scores, scaled after the dot in f32 (the TPU kernel's order)
  for (int idx = threadIdx.x; idx < seq * seq; idx += blockDim.x) {
    const int i = idx / seq, j = idx - i * seq;
    float s = -INFINITY;
    if (!causal || j <= i) {
      const float* qi = qs + i * ld;
      const float* kj = ks + j * ld;
      float a = 0.f;
      for (int d = 0; d < head_dim; ++d) a = fmaf(qi[d], kj[d], a);
      s = __fmul_rn(a, scale);
    }
    ps[i * lds + j] = s;
  }
  __syncthreads();

  // f32 softmax, one warp per row; probabilities rounded to the compute type
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < seq; i += kAttnThreads / 32) {
    float* pr = ps + i * lds;
    float mx = -INFINITY;
    for (int j = lane; j < seq; j += 32) mx = fmaxf(mx, pr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float e = expf(__fsub_rn(pr[j], mx));
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < seq; j += 32) pr[j] = round_to<T>(__fdiv_rn(pr[j], sum));
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < seq * head_dim; idx += blockDim.x) {
    const int i = idx / head_dim, d = idx - i * head_dim;
    const float* pr = ps + i * lds;
    float a = 0.f;
    for (int j = 0; j < seq; ++j) a = fmaf(pr[j], vs[j * ld + d], a);
    out[(row0 + i) * width + h * head_dim + d] = from_f32<T>(a);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

struct Workspace {
  int8_t* hq;   // (m, width)  LN1 rows, int8
  float* hs;    // (m,)
  void* qkv;    // (m, 3 width) compute type
  void* attn;   // (m, width)  compute type
  int8_t* aq;   // (m, width)
  float* as;    // (m,)
  void* x1;     // (m, width)  compute type, after the attention residual
  int8_t* h2q;  // (m, width)  LN2 rows, int8
  float* h2s;   // (m,)
  float* g;     // (m, hidden) f32 quick_gelu(fc1)
  int8_t* gq;   // (m, hidden)
  float* gs;    // (m,)
};

// Lays the workspace out from `base` (or only sizes it when base is null).
size_t carve(char* base, int m, int width, int hidden, int eb, Workspace* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  const size_t mw = (size_t)m * width, mh = (size_t)m * hidden;
  w->hq = (int8_t*)take(mw);
  w->hs = (float*)take(m * sizeof(float));
  w->qkv = take(3 * mw * eb);
  w->attn = take(mw * eb);
  w->aq = (int8_t*)take(mw);
  w->as = (float*)take(m * sizeof(float));
  w->x1 = take(mw * eb);
  w->h2q = (int8_t*)take(mw);
  w->h2s = (float*)take(m * sizeof(float));
  w->g = (float*)take(mh * sizeof(float));
  w->gq = (int8_t*)take(mh);
  w->gs = (float*)take(m * sizeof(float));
  return off;
}

// Launch, then report a refused launch (too many threads, too much shared
// memory) at once: it never runs, and a later synchronize would not say so.
#define IRT_TRY(...)                              \
  do {                                            \
    __VA_ARGS__;                                  \
    const cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)

template <typename T>
int run_layer(const T* x, T* out, const float* ln1_s, const float* ln1_b,
              const int8_t* wqkv_t, const float* wqkv_s, const float* bqkv,
              const int8_t* wo_t, const float* wo_s, const float* bo,
              const float* ln2_s, const float* ln2_b,
              const int8_t* w1_t, const float* w1_s, const float* b1,
              const int8_t* w2_t, const float* w2_s, const float* b2,
              char* workspace, int batch, int seq, int width, int hidden, int heads,
              int causal, float scale, cudaStream_t st) {
  Workspace w;
  carve(workspace, batch * seq, width, hidden, (int)sizeof(T), &w);
  const int m = batch * seq;
  const int hd = width / heads;
  const dim3 rows(m);
  const size_t ln_smem = width * sizeof(float);
  const int mt = (m + BM - 1) / BM;
  T* qkv = (T*)w.qkv;
  T* attn = (T*)w.attn;
  T* x1 = (T*)w.x1;

  // attention sub-block
  IRT_TRY(ln_rowquant_kernel<T, true><<<rows, kRowThreads, ln_smem, st>>>(
      x, ln1_s, ln1_b, w.hq, w.hs, width));
  IRT_TRY(gemm_s8_kernel<T, kStore><<<dim3(3 * width / BN, mt), kGemmThreads, 0, st>>>(
      w.hq, wqkv_t, w.hs, wqkv_s, bqkv, nullptr, qkv, m, 3 * width, width));
  const size_t asmem = irt_attention_smem_bytes(seq, hd);
  const cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)asmem);
  if (e != cudaSuccess) return (int)e;
  IRT_TRY(attention_kernel<T><<<dim3(heads, batch), kAttnThreads, asmem, st>>>(
      qkv, attn, seq, width, hd, causal, scale));
  IRT_TRY(ln_rowquant_kernel<T, false><<<rows, kRowThreads, ln_smem, st>>>(
      attn, nullptr, nullptr, w.aq, w.as, width));
  IRT_TRY(gemm_s8_kernel<T, kResidual><<<dim3(width / BN, mt), kGemmThreads, 0, st>>>(
      w.aq, wo_t, w.as, wo_s, bo, x, x1, m, width, width));
  // MLP sub-block
  IRT_TRY(ln_rowquant_kernel<T, true><<<rows, kRowThreads, ln_smem, st>>>(
      x1, ln2_s, ln2_b, w.h2q, w.h2s, width));
  IRT_TRY(gemm_s8_kernel<float, kGelu><<<dim3(hidden / BN, mt), kGemmThreads, 0, st>>>(
      w.h2q, w1_t, w.h2s, w1_s, b1, nullptr, w.g, m, hidden, width));
  IRT_TRY(ln_rowquant_kernel<float, false><<<rows, kRowThreads, hidden * sizeof(float), st>>>(
      w.g, nullptr, nullptr, w.gq, w.gs, hidden));
  IRT_TRY(gemm_s8_kernel<T, kResidual><<<dim3(width / BN, mt), kGemmThreads, 0, st>>>(
      w.gq, w2_t, w.gs, w2_s, b2, x1, out, m, width, hidden));
  return 0;
}

}  // namespace

extern "C" {

size_t irt_layer_block_int8_workspace_bytes(int m, int width, int hidden, int elem_bytes) {
  Workspace w;
  return carve(nullptr, m, width, hidden, elem_bytes, &w);
}

size_t irt_attention_smem_bytes(int seq, int head_dim) {
  return (size_t)(3 * seq * (head_dim + 1) + seq * (seq + 1)) * sizeof(float);
}

int irt_layer_block_int8(
    const void* x, void* out,
    const void* ln1_s, const void* ln1_b,
    const void* wqkv_t, const void* wqkv_s, const void* bqkv,
    const void* wo_t, const void* wo_s, const void* bo,
    const void* ln2_s, const void* ln2_b,
    const void* w1_t, const void* w1_s, const void* b1,
    const void* w2_t, const void* w2_s, const void* b2,
    void* workspace, int batch, int seq, int width, int hidden, int heads,
    int causal, int dtype, float attn_scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || width % 64 || hidden % 64 ||
      width % heads || width / heads > 128 || (dtype != 0 && dtype != 1) ||
      (size_t)batch * seq > 65535u * BM ||
      irt_attention_smem_bytes(seq, width / heads) > 232448u) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
#define IRT_ARGS(T)                                                                 \
  (const T*)x, (T*)out, (const float*)ln1_s, (const float*)ln1_b,                  \
      (const int8_t*)wqkv_t, (const float*)wqkv_s, (const float*)bqkv,             \
      (const int8_t*)wo_t, (const float*)wo_s, (const float*)bo,                   \
      (const float*)ln2_s, (const float*)ln2_b, (const int8_t*)w1_t,               \
      (const float*)w1_s, (const float*)b1, (const int8_t*)w2_t,                   \
      (const float*)w2_s, (const float*)b2, (char*)workspace, batch, seq, width,   \
      hidden, heads, causal, attn_scale, st
  if (dtype == 0) return run_layer<__nv_bfloat16>(IRT_ARGS(__nv_bfloat16));
  return run_layer<float>(IRT_ARGS(float));
#undef IRT_ARGS
}

const char* irt_error_string(int code) {
  if (code == IRT_BAD_ARGS) {
    return "invalid shape, dtype or alignment for the kernel";
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
