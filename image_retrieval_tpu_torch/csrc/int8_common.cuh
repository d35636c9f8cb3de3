// Device code shared by the Hopper (sm_90a) int8 serving kernels:
// layer_block_int8.cu (whole layer), attention_block_int8.cu and
// mlp_block_int8.cu (its two halves) and quant_dense.cu (one projection).
// Each is a chain of these simple kernels, every one reading its operands
// once from device memory (the 50 MB L2 holds a layer's weights and
// activations between launches):
//   (a) ln_rowquant_kernel      LayerNorm (f32, fast variance) fused with the
//                               per-row int8 quantization; a warp per row
//                               (up to 2,048 values, held in registers),
//                               eight rows a block.
//   (b) gemm_persistent_kernel  int8 GEMM on the tensor cores
//                               (gemm_sm90.cuh: the bf16 chains' persistent
//                               kernel, tiles of 128 columns and 64-192
//                               rows, wgmma m64n128k32 with int32 sums fed
//                               by TMA, bf16 outputs stored by TMA from
//                               shared memory under the next tile's
//                               products) and a fused epilogue: acc *
//                               row_scale * col_scale + bias, then
//                               quick_gelu in f32 or the residual add in the
//                               compute type.
//   (c) gemm_wgmma_s8_rowquant_kernel  the same GEMM for fc1 with quick_gelu
//                               and the per-row requantization in its
//                               epilogue, a thread block cluster per row
//                               tile (gemm_sm90.cuh): the f32 hidden rows
//                               stay in registers.
//   (d) the attention of attention_sm90.cuh (bf16: attention_wgmma_kernel
//       or attention_tiled_mma_kernel on the tensor cores; f32:
//       attention_tiled_kernel), on packed
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
#include "attention_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// (a) LayerNorm + per-row int8 quantization
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 8;     // warps of a block
constexpr int kRowMaxPer = 64;   // values a lane holds, at most
// the widest row: six warps of 2,048 values
constexpr int kMaxRowWidth = 6 * 32 * kRowMaxPer;

// 16 bytes of a row as f32: eight bf16 or four f32 values.
template <typename In> struct RowVec;
template <> struct RowVec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};
template <> struct RowVec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

// `row_warps` warps per row, kRowWarps / row_warps rows per block; a lane
// holds kPer values of its row in registers, 16-byte vectors at element
// (c * 32 row_warps + lane of the row) * n for c = 0, 1, ... With kLN, the
// row is first normalized: (x - mu) * rsqrt(E[x^2] - mu^2 (>= 0) + 1e-5) *
// gamma + beta. Then s = max(absmax, 1e-12) / 127 and q =
// round_half_even(h / s). Sums and maxima are shuffle reductions within a
// warp; a row of several warps (width > 2,048) adds their partials in warp
// order through shared memory. Every pass of a given width sums in one
// order, whichever chain launches it.
template <typename In, bool kLN, int kPer>
__global__ void __launch_bounds__(kRowWarps * 32) ln_rowquant_kernel(
    const In* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, int8_t* __restrict__ q,
    float* __restrict__ qscale, int m, int width, int row_warps) {
  constexpr int kN = RowVec<In>::n;
  constexpr int kChunks = kPer / kN;
  __shared__ float part[2][kRowWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / row_warps;  // the block's row of this warp
  const long long row = (long long)blockIdx.x * (kRowWarps / row_warps) + slot;
  const bool live = slot < kRowWarps / row_warps && row < m;
  const int e0 = ((warp % row_warps) * 32 + lane) * kN, step = 32 * row_warps * kN;
  const size_t base = (size_t)row * width;
  float v[kPer];
  bool valid[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    valid[c] = live && e0 + c * step < width;
    if (valid[c]) {
      RowVec<In>::load(x + base + e0 + c * step, v + c * kN);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) v[c * kN + j] = 0.f;
    }
  }
  // the partials of the row's warps, in warp order, once the block is there
  auto across = [&](float a, float b, bool max, float* ra, float* rb) {
    if (row_warps > 1) {
      __syncthreads();  // part[] free from its previous use
      if (lane == 0) {
        part[0][warp] = a;
        part[1][warp] = b;
      }
      __syncthreads();
      if (slot < kRowWarps / row_warps) {  // warps past the block's rows hold none
        const float* pa = &part[0][slot * row_warps];
        const float* pb = &part[1][slot * row_warps];
        a = pa[0];
        b = pb[0];
        for (int i = 1; i < row_warps; ++i) {
          a = max ? fmaxf(a, pa[i]) : a + pa[i];
          b = max ? fmaxf(b, pb[i]) : b + pb[i];
        }
      }
    }
    *ra = a;
    *rb = b;
  };
  if (kLN) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      sum += v[i];
      sq = fmaf(v[i], v[i], sq);
    }
    across(warp_sum(sum), warp_sum(sq), false, &sum, &sq);
    const float mu = __fdiv_rn(sum, (float)width);
    const float ms = __fdiv_rn(sq, (float)width);
    const float var = fmaxf(__fsub_rn(ms, __fmul_rn(mu, mu)), 0.f);
    const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, 1e-5f)));
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (!valid[c]) continue;
      float g[kN], b[kN];
      RowVec<float>::load(gamma + e0 + c * step, g);
      RowVec<float>::load(beta + e0 + c * step, b);
      if constexpr (kN == 8) {
        RowVec<float>::load(gamma + e0 + c * step + 4, g + 4);
        RowVec<float>::load(beta + e0 + c * step + 4, b + 4);
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float h = __fmul_rn(__fmul_rn(__fsub_rn(v[c * kN + j], mu), inv), g[j]);
        v[c * kN + j] = __fadd_rn(h, b[j]);
      }
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!valid[c]) continue;
#pragma unroll
    for (int j = 0; j < kN; ++j) amax = fmaxf(amax, fabsf(v[c * kN + j]));
  }
  float unused;
  across(warp_max(amax), 0.f, true, &amax, &unused);
  if (!live) return;
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!valid[c]) continue;
    uint32_t word[kN / 4];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const uint32_t b = (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fdiv_rn(v[c * kN + j], s));
      if (j % 4 == 0) word[j / 4] = 0;
      word[j / 4] |= b << (8 * (j % 4));
    }
    int8_t* out = q + base + e0 + c * step;
    if constexpr (kN == 8) {
      *reinterpret_cast<uint2*>(out) = make_uint2(word[0], word[1]);
    } else {
      *reinterpret_cast<uint32_t*>(out) = word[0];
    }
  }
  if (e0 == 0) qscale[row] = s;
}

// ---------------------------------------------------------------------------
// (b) int8 GEMM with fused dequant epilogue
// ---------------------------------------------------------------------------

enum Epilogue { kStore = 0, kGelu = 1, kResidual = 2 };

// One output from its int32 sum: acc * rs * cs + b in f32, then with kGelu
// quick_gelu in f32, v * (1 / (1 + exp(-1.702 v))).
template <int kEpi>
__device__ __forceinline__ float int8_dequant(int acc, float rs, float cs, float b) {
  float v = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs), b);
  if (kEpi == kGelu) {
    const float z = __fmul_rn(1.702f, v);
    v = __fmul_rn(v, __frcp_rn(__fadd_rn(1.f, expf(-z))));
  }
  return v;
}

// The epilogue of the int8 GEMM (gemm_persistent_kernel, gemm_sm90.cuh):
// one output from its int32 sum, acc * row_scale * col_scale + bias in f32,
// then quick_gelu in f32, or the cast and the residual add in the compute
// type; the kernel casts the value to OutT. The column scales and biases
// are the tile's two staged column parameters, the row scale is held in
// registers.
template <typename OutT, int kEpi>
struct Int8Epilogue {
  typedef OutT Out;
  static constexpr int kColParams = 2;  // col_scale, bias
  static constexpr bool kRowScale = true;
  static constexpr bool kAddsResidual = kEpi == kResidual;
  const float* row_scale;
  const float* col_scale;
  const float* bias;
  int m, n;
  __device__ __forceinline__ const float* col_param(int j) const {
    return j == 0 ? col_scale : bias;
  }
  __device__ __forceinline__ float operator()(int acc, float rs, float cs, float b,
                                              float res) const {
    float v = int8_dequant<kEpi == kGelu ? kGelu : kStore>(acc, rs, cs, b);
    if (kEpi == kResidual) v = __fadd_rn(res, round_to<OutT>(v));  // cast, then add
    return v;
  }
  // The same without a residual (the clustered rowquant GEMM's finish).
  __device__ __forceinline__ float finish(int acc, float rs, float cs, float b) const {
    static_assert(kEpi != kResidual, "the residual epilogue reads the residual");
    return int8_dequant<kEpi>(acc, rs, cs, b);
  }
};

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Values a lane holds for a row of `width`: the fewest of 8, 16, 32 and 64
// that one warp covers, else 64 on ceil(width / 2,048) warps.
inline int row_per_lane(int width) {
  return width <= 256 ? 8 : width <= 512 ? 16 : width <= 1024 ? 32 : kRowMaxPer;
}

template <typename In, bool kLN>
int launch_ln_rowquant(const In* x, const float* gamma, const float* beta, int8_t* q,
                       float* qscale, int m, int width, cudaStream_t st) {
  const int per = row_per_lane(width);
  const int row_warps = (width + 32 * per - 1) / (32 * per);
  const int rows = kRowWarps / row_warps;
  const dim3 grid((m + rows - 1) / rows);
#define IRT_ROW_PASS(P)                                                                  \
  IRT_TRY(ln_rowquant_kernel<In, kLN, P><<<grid, kRowWarps * 32, 0, st>>>(                \
      x, gamma, beta, q, qscale, m, width, row_warps))
  if (per == 8) {
    IRT_ROW_PASS(8);
  } else if (per == 16) {
    IRT_ROW_PASS(16);
  } else if (per == 32) {
    IRT_ROW_PASS(32);
  } else {
    IRT_ROW_PASS(64);
  }
#undef IRT_ROW_PASS
  return 0;
}

template <typename OutT, int kEpi>
int launch_gemm_s8(const int8_t* a, const int8_t* bt, const float* row_scale,
                   const float* col_scale, const float* bias, const OutT* residual,
                   OutT* c, int m, int n, int k, cudaStream_t st) {
  return launch_gemm_tc<int8_t>(a, bt, residual, c, k,
                               Int8Epilogue<OutT, kEpi>{row_scale, col_scale, bias, m, n}, st);
}

typedef Int8Epilogue<float, kGelu> GeluFinish;

// gq, gs = rowquant(quick_gelu(a bt^T * row_scale * col_scale + bias)) by
// the route rowquant_gemm_plan gives the shape: one clustered launch
// (gemm_wgmma_s8_rowquant_kernel), or the f32 GEMM into g (m, n) and a
// rowquant launch. g is used, and must be given, on the second route only.
inline int launch_gemm_s8_gelu_rowquant(const int8_t* a, const int8_t* bt,
                                        const float* row_scale, const float* col_scale,
                                        const float* bias, float* g, int8_t* gq, float* gs,
                                        int m, int n, int k, cudaStream_t st) {
  RowquantGemmPlan p;
  if (!rowquant_gemm_plan(m, n, k, &p)) return IRT_BAD_ARGS;
  const GeluFinish fin{row_scale, col_scale, bias, m, n};
  if (p.fused) return launch_gemm_s8_rowquant(a, bt, k, fin, gq, gs, st);
  if (g == nullptr || n > kMaxRowWidth) return IRT_BAD_ARGS;
  IRT_CHECK((launch_gemm_s8<float, kGelu>(a, bt, row_scale, col_scale, bias, nullptr, g, m, n,
                                          k, st)));
  return launch_ln_rowquant<float, false>(g, nullptr, nullptr, gq, gs, m, n, st);
}

// Bytes of the f32 (m, n) buffer the second route needs: 0 on the fused one.
inline size_t gelu_rowquant_f32_bytes(int m, int n, int k) {
  RowquantGemmPlan p;
  return rowquant_gemm_plan(m, n, k, &p) && p.fused ? 0 : (size_t)m * n * sizeof(float);
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

// The MLP sub-block: LN2 -> rowquant -> int8 fc1 -> quick_gelu in f32 ->
// rowquant -> int8 fc2 -> x + out. Three launches where a cluster covers
// the hidden row (hidden a multiple of 512 up to 4,096: every tower of the
// presets), fc1 -> quick_gelu -> rowquant being one; four elsewhere, with
// the f32 hidden rows in the workspace (rowquant_gemm_plan).
struct MlpWorkspace {
  int8_t* hq;  // (m, width)  LN2 rows, int8
  float* hs;   // (m,)
  float* g;    // (m, hidden) f32 quick_gelu(fc1), on the two-launch route only
  int8_t* gq;  // (m, hidden)
  float* gs;   // (m,)
};

inline void carve_mlp(Carver& c, int m, int width, int hidden, MlpWorkspace* w) {
  const size_t mw = (size_t)m * width, mh = (size_t)m * hidden;
  const size_t g_bytes = gelu_rowquant_f32_bytes(m, hidden, width);
  w->hq = (int8_t*)c.take(mw);
  w->hs = (float*)c.take(m * sizeof(float));
  w->g = g_bytes ? (float*)c.take(g_bytes) : nullptr;
  w->gq = (int8_t*)c.take(mh);
  w->gs = (float*)c.take(m * sizeof(float));
}

template <typename T>
int run_mlp_block(const T* x, T* out, const float* ln_s, const float* ln_b,
                  const int8_t* w1_t, const float* w1_s, const float* b1,
                  const int8_t* w2_t, const float* w2_s, const float* b2,
                  const MlpWorkspace& w, int m, int width, int hidden, cudaStream_t st) {
  IRT_CHECK((launch_ln_rowquant<T, true>(x, ln_s, ln_b, w.hq, w.hs, m, width, st)));
  IRT_CHECK(launch_gemm_s8_gelu_rowquant(w.hq, w1_t, w.hs, w1_s, b1, w.g, w.gq, w.gs, m, hidden,
                                         width, st));
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
