// Device and host code shared by the Hopper (sm_90a) transformer-layer kernel
// chains: the int8 serving family (int8_common.cuh) and the family in the
// compute type (dense_common.cuh). Type helpers, warp and block reductions,
// cp.async, the bf16 mma, the workspace carver, the launch checks, and the
// f32 form of the attention step:
//   attention_tiled_kernel      f32: one block per (head, image, tile of
//                               query rows), K, V, Q and score rows in
//                               shared memory, every product an exact f32
//                               FMA on the CUDA cores. The port's f32 paths
//                               never use TF32 (device.require_full_f32),
//                               so f32 stays off the tensor cores; no bf16
//                               path reaches this kernel.
// The bf16 forms run on the tensor cores: attention_wgmma_kernel
// (attention_sm90.cuh, 81-288 keys at head_dim 64) and
// attention_tiled_mma_kernel (attention_mma.cuh, every other shape);
// attention_sm90.cuh also holds the dispatch every chain and
// multihead_attention share (launch_attention_as). All: exact two-pass f32
// softmax, probabilities cast to the compute type, PV accumulated in f32.
// Everything sits in an anonymous namespace: each source that includes this
// file gets its own copy and instantiates only the kernels it launches.
// Built without --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#ifndef IRT_BAD_ARGS
#define IRT_BAD_ARGS 100000
#endif

// Most dynamic shared memory one block may ask for on sm_90 (227 KB).
#define IRT_MAX_SMEM 232448

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
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

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

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// Attention in f32, tiled over the query rows
// ---------------------------------------------------------------------------

constexpr int kAttnThreads = 256;
constexpr int kAttnMaxTile = 64;  // query rows per block, at most
constexpr int kAttnRows = 4;      // query rows per thread

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Floats of dynamic shared memory of one block: K rows padded by 4 (16-byte
// row loads by 8 neighbouring lanes hit distinct banks), V rows, the
// tile's Q rows and its score rows; every row count rounded up to 4.
inline size_t attention_smem_floats(int seq, int head_dim, int tile) {
  const size_t s4 = round4(seq), t4 = round4(tile);
  return s4 * (head_dim + 4) + s4 * head_dim + t4 * (head_dim + 4) + t4 * s4;
}

// Query rows per block for (seq, head_dim): the largest power of two up to
// 64 that is not needlessly larger than seq and whose block fits in shared
// memory; 0 when not even one row fits beside the whole K and V.
inline int attention_tile_rows(int seq, int head_dim) {
  int tile = kAttnMaxTile;
  while (tile > 1 && tile / 2 >= seq) tile /= 2;
  while (tile > 1 && attention_smem_floats(seq, head_dim, tile) * sizeof(float) > IRT_MAX_SMEM)
    tile /= 2;
  return attention_smem_floats(seq, head_dim, tile) * sizeof(float) > IRT_MAX_SMEM ? 0 : tile;
}

// q, k, v: (batch * seq) rows of `width` values each, `ld` elements from one
// row to the next, heads contiguous inside a row: three tensors (ld = width)
// or the three thirds of packed [q | k | v] rows (ld = 3 * width). out:
// (batch * seq, width). Grid (heads, batch, ceil(seq / tile)).
// head_dim % 4 == 0. A block takes query rows [q0, q0 + rows) of one
// (image, head) against keys [0, kv): all of them, or with `causal` those
// up to the tile's last row. Per row the order of operations is: dot over
// d (fmaf, ascending), times scale, mask, max, exp(s - max), sum, divide,
// round to T, then PV over ascending j (fmaf). With kSaveProbs the quotient
// is also written, in f32 and before that rounding, to `probs` (batch, heads,
// seq, seq): whole rows, with exact zeros at the keys a causal block never
// visits. The flag adds stores only: the other outputs are the same bits.
template <typename T, bool kSaveProbs>
__global__ void __launch_bounds__(kAttnThreads) attention_tiled_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, size_t ld,
    T* __restrict__ out, float* __restrict__ probs, int seq, int width, int head_dim, int tile,
    int causal, float scale) {
  static_assert(std::is_same<T, float>::value,
                "bf16 attention runs on the tensor cores (attention_mma.cuh)");
  extern __shared__ __align__(16) float sm[];
  const int ldk = head_dim + 4;
  const int ldp = round4(seq);
  const int t4 = round4(tile);
  float* ks = sm;                     // round4(seq) x ldk
  float* vs = ks + (size_t)ldp * ldk;  // round4(seq) x head_dim
  float* qs = vs + (size_t)ldp * head_dim;  // t4 x ldk
  float* ps = qs + (size_t)t4 * ldk;        // t4 x ldp scores, then probabilities
  const int h = blockIdx.x;
  const size_t row0 = (size_t)blockIdx.y * seq;
  const int q0 = blockIdx.z * tile;
  const int rows = min(tile, seq - q0);
  const int kv = causal ? q0 + rows : seq;
  const int kv4 = round4(kv);
  const int groups = (rows + kAttnRows - 1) / kAttnRows;

  // K and V rows [0, kv4) (zeros past kv), Q rows [0, 4 * groups) (zeros
  // past rows): the padded rows are read but weigh nothing
  for (int idx = threadIdx.x; idx < kv4 * head_dim; idx += blockDim.x) {
    const int t = idx / head_dim, d = idx - t * head_dim;
    float kvl = 0.f, vvl = 0.f;
    if (t < kv) {
      const size_t at = (row0 + t) * ld + h * head_dim + d;
      kvl = to_f32(k[at]);
      vvl = to_f32(v[at]);
    }
    ks[t * ldk + d] = kvl;
    vs[t * head_dim + d] = vvl;
  }
  for (int idx = threadIdx.x; idx < groups * kAttnRows * head_dim; idx += blockDim.x) {
    const int t = idx / head_dim, d = idx - t * head_dim;
    qs[t * ldk + d] =
        t < rows ? to_f32(q[(row0 + q0 + t) * ld + h * head_dim + d]) : 0.f;
  }
  __syncthreads();

  // scores: a thread takes one key and four query rows
  for (int it = threadIdx.x; it < groups * kv; it += blockDim.x) {
    const int g = it / kv, j = it - g * kv;
    const float4* kp = reinterpret_cast<const float4*>(ks + j * ldk);
    const float4* qp = reinterpret_cast<const float4*>(qs + g * kAttnRows * ldk);
    const int ldq4 = ldk / 4;
    float a[kAttnRows] = {0.f, 0.f, 0.f, 0.f};
    for (int d4 = 0; d4 < head_dim / 4; ++d4) {
      const float4 kk = kp[d4];
#pragma unroll
      for (int r = 0; r < kAttnRows; ++r) {
        const float4 qq = qp[r * ldq4 + d4];
        a[r] = fmaf(qq.x, kk.x, a[r]);
        a[r] = fmaf(qq.y, kk.y, a[r]);
        a[r] = fmaf(qq.z, kk.z, a[r]);
        a[r] = fmaf(qq.w, kk.w, a[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kAttnRows; ++r) {
      const int i = g * kAttnRows + r;  // row inside the tile
      // scaled after the dot in f32 (the TPU kernel's order)
      ps[i * ldp + j] = (causal && j > q0 + i) ? -INFINITY : __fmul_rn(a[r], scale);
    }
  }
  __syncthreads();

  // f32 softmax, one warp per row; probabilities rounded to the compute
  // type; columns [kv, kv4) zeroed for the four-wide PV loop
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < groups * kAttnRows; i += kAttnThreads / 32) {
    float* pr = ps + i * ldp;
    if (i >= rows) {  // padding rows of the last group
      for (int j = lane; j < kv4; j += 32) pr[j] = 0.f;
      continue;
    }
    float mx = -INFINITY;
    for (int j = lane; j < kv; j += 32) mx = fmaxf(mx, pr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < kv; j += 32) {
      const float e = expf(__fsub_rn(pr[j], mx));
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float* saved = nullptr;
    if (kSaveProbs) {
      saved = probs + (((size_t)blockIdx.y * gridDim.x + h) * seq + q0 + i) * seq;
      for (int j = kv + lane; j < seq; j += 32) saved[j] = 0.f;
    }
    for (int j = lane; j < kv4; j += 32) {
      const float p = j < kv ? __fdiv_rn(pr[j], sum) : 0.f;
      if (kSaveProbs && j < kv) saved[j] = p;
      pr[j] = round_to<T>(p);
    }
  }
  __syncthreads();

  // PV: a thread takes one output column and four query rows
  for (int it = threadIdx.x; it < groups * head_dim; it += blockDim.x) {
    const int g = it / head_dim, d = it - g * head_dim;
    const float4* pp = reinterpret_cast<const float4*>(ps + g * kAttnRows * ldp);
    const int ldp4 = ldp / 4;
    float a[kAttnRows] = {0.f, 0.f, 0.f, 0.f};
    for (int j4 = 0; j4 < kv4 / 4; ++j4) {
      const float* vp = vs + (j4 * 4) * head_dim + d;
      const float v0 = vp[0], v1 = vp[head_dim], v2 = vp[2 * head_dim], v3 = vp[3 * head_dim];
#pragma unroll
      for (int r = 0; r < kAttnRows; ++r) {
        const float4 p = pp[r * ldp4 + j4];
        a[r] = fmaf(p.x, v0, a[r]);
        a[r] = fmaf(p.y, v1, a[r]);
        a[r] = fmaf(p.z, v2, a[r]);
        a[r] = fmaf(p.w, v3, a[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kAttnRows; ++r) {
      const int i = g * kAttnRows + r;
      if (i < rows) out[(row0 + q0 + i) * width + h * head_dim + d] = from_f32<T>(a[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// Hands out 256-byte aligned pieces of a workspace from `base`, or only
// sizes them when base is null.
struct Carver {
  char* base;
  size_t off = 0;
  explicit Carver(void* b) : base((char*)b) {}
  void* take(size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  }
};

// Launch, then report a refused launch (too many threads, too much shared
// memory) at once: it never runs, and a later synchronize would not say so.
#define IRT_TRY(...)                              \
  do {                                            \
    __VA_ARGS__;                                  \
    const cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)

// The GEMM (gemm_sm90.cuh) tiles at least 64 rows per block, and gridDim.y
// carries the row tiles.
constexpr size_t kMaxRows = (size_t)65535 * 64;

inline bool rows_ok(long long m) { return m > 0 && (size_t)m <= kMaxRows; }

#define IRT_CHECK(call)          \
  do {                           \
    const int rc_ = (call);      \
    if (rc_ != 0) return rc_;    \
  } while (0)

}  // namespace
