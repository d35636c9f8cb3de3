// Hopper (sm_90a) int8 whole-layer serving kernel chain.
//
// Replaces the TPU kernel image_retrieval_tpu/ops/flash_attention.py
// _layer_block_int8_kernel (l.772, called at l.855 through
// _pallas_layer_block_int8 and layer_block_int8, l.879): one pre-LN CLIP
// transformer layer with int8 x int8 -> int32 projections.
//
// What bounds it on this card. One ViT-B/32 layer reads ~7 MB of int8
// weights (12 W^2 bytes) and does 24 W^2 int8 operations per token: at
// the serving batches (256 images of 50 tokens, 64 texts of 77) that is
// 181 G and 31 G operations against ~2 us of weight traffic at 3.35 TB/s,
// so the layer is bound by operations (tensor-core rate), and at small
// batches by launch latency and the serial chain of eight launches. The TPU
// design (all layer weights resident in VMEM across the image grid) does
// not transfer: 7 MB is ~30x one SM's 227 KB of shared memory.
//
// What the design does about it. The chain of int8_common.cuh: the
// attention sub-block's five launches, then the MLP sub-block's three (four
// where no cluster covers the hidden row), with the mid-layer activation x1
// kept in the workspace. The row passes (LayerNorm and rowquant) take a
// warp per row. The attention (attention_sm90.cuh) keeps an (image, head)'s
// K and V in shared memory and the score rows in registers (bf16) or tiles
// the query rows (f32), so T = 197 and 257 run. The GEMMs are
// gemm_sm90.cuh's (wgmma fed by TMA); fc1, quick_gelu and the
// requantization of the hidden rows are one clustered launch, so the f32
// hidden rows never reach device memory. Fusing the rest of the chain is
// later work.

#include "layer_block_int8.cuh"

#include "int8_common.cuh"

namespace {

template <typename T>
int run_layer(const T* x, T* out, const float* ln1_s, const float* ln1_b,
              const int8_t* wqkv_t, const float* wqkv_s, const float* bqkv,
              const int8_t* wo_t, const float* wo_s, const float* bo,
              const float* ln2_s, const float* ln2_b,
              const int8_t* w1_t, const float* w1_s, const float* b1,
              const int8_t* w2_t, const float* w2_s, const float* b2,
              void* workspace, int batch, int seq, int width, int hidden, int heads,
              int causal, float scale, cudaStream_t st) {
  const int m = batch * seq;
  Carver c(workspace);
  AttnWorkspace aw;
  MlpWorkspace mw;
  carve_attn(c, m, width, (int)sizeof(T), &aw);
  T* x1 = (T*)c.take((size_t)m * width * sizeof(T));  // after the attention residual
  carve_mlp(c, m, width, hidden, &mw);
  IRT_CHECK(run_attn_block<T>(x, x1, ln1_s, ln1_b, wqkv_t, wqkv_s, bqkv, wo_t, wo_s, bo, aw,
                              batch, seq, width, heads, causal, scale, st));
  return run_mlp_block<T>(x1, out, ln2_s, ln2_b, w1_t, w1_s, b1, w2_t, w2_s, b2, mw, m, width,
                          hidden, st);
}

// Self-check of div_rn_by against __fdiv_rn over its range: n pseudo-random
// pairs (a in [2^-90, 2), b in [1, 2^9)) and a = 1 against each b; adds the
// count of quotients that differ to *mismatches.
__global__ void attention_division_check_kernel(unsigned long long* mismatches, long long n) {
  unsigned long long bad = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    unsigned long long h = (unsigned long long)i * 0x9e3779b97f4a7c15ull;  // splitmix64
    h = (h ^ (h >> 30)) * 0xbf58476d1ce4e5b9ull;
    h = (h ^ (h >> 27)) * 0x94d049bb133111ebull;
    h ^= h >> 31;
    const unsigned lo = (unsigned)h, hi = (unsigned)(h >> 32);
    const float a = __int_as_float((int)(((127u - (hi >> 23) % 91u) << 23) | (lo & 0x7fffffu)));
    const float b = __int_as_float((int)(((127u + (lo >> 23) % 9u) << 23) | (hi & 0x7fffffu)));
    const float y = __frcp_rn(b);
    bad += __fdiv_rn(a, b) != div_rn_by(a, b, y);
    bad += __fdiv_rn(1.f, b) != div_rn_by(1.f, b, y);
  }
  atomicAdd(mismatches, bad);
}

// Self-check of attn_exp8 against expf: n pseudo-random u <= 0 (dots below
// a row's max, from 2^-30 to 2^12 in size, and 0 and -inf) with
// attn_exp8(u) != expf(u / 8) added to *mismatches.
__global__ void attention_exp_check_kernel(unsigned long long* mismatches, long long n) {
  unsigned long long bad = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    unsigned long long h = (unsigned long long)i * 0x9e3779b97f4a7c15ull;  // splitmix64
    h = (h ^ (h >> 30)) * 0xbf58476d1ce4e5b9ull;
    h = (h ^ (h >> 27)) * 0x94d049bb133111ebull;
    h ^= h >> 31;
    const unsigned lo = (unsigned)h, hi = (unsigned)(h >> 32);
    float u = -__int_as_float((int)(((97u + (hi >> 23) % 43u) << 23) | (lo & 0x7fffffu)));
    if (i == 0) u = 0.f;
    if (i == 1) u = -INFINITY;
    bad += __float_as_int(attn_exp8(u)) != __float_as_int(expf(__fmul_rn(u, 0.125f)));
  }
  atomicAdd(mismatches, bad);
}

}  // namespace

extern "C" {

size_t irt_layer_block_int8_workspace_bytes(int m, int width, int hidden, int elem_bytes) {
  Carver c(nullptr);
  AttnWorkspace aw;
  MlpWorkspace mw;
  carve_attn(c, m, width, elem_bytes, &aw);
  c.take((size_t)m * width * elem_bytes);
  carve_mlp(c, m, width, hidden, &mw);
  return c.off;
}

int irt_attention_tile_rows(int seq, int head_dim, int dtype, int pairs) {
  if (seq <= 0 || head_dim <= 0 || pairs <= 0 || head_dim % 4 || head_dim > 128) return 0;
  if (dtype == 0) {
    return attention_bf16_smem_bytes(seq, head_dim) <= IRT_MAX_SMEM
               ? attention_bf16_rows(seq, head_dim, pairs) : 0;
  }
  return attention_tile_rows(seq, head_dim);
}

size_t irt_attention_smem_bytes(int seq, int head_dim, int dtype) {
  if (dtype == 0) return attention_bf16_smem_bytes(seq, head_dim);
  const int tile = seq > 0 && head_dim > 0 ? attention_tile_rows(seq, head_dim) : 0;
  return attention_smem_floats(seq, head_dim, tile > 0 ? tile : 1) * sizeof(float);
}

int irt_attention_route(int seq, int head_dim, int dtype) {
  return dtype == 0 ? attention_route(seq, head_dim) : kRouteScalarF32;
}

int irt_attention_division_check(void* mismatches, long long n, void* stream) {
  if (mismatches == nullptr || n < 0) return IRT_BAD_ARGS;
  IRT_TRY(attention_division_check_kernel<<<4 * 132, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)mismatches, n));
  return 0;
}

int irt_attention_exp_check(void* mismatches, long long n, void* stream) {
  if (mismatches == nullptr || n < 0) return IRT_BAD_ARGS;
  IRT_TRY(attention_exp_check_kernel<<<4 * 132, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)mismatches, n));
  return 0;
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
  if (!block_shape_ok(batch, seq, width, hidden, dtype) ||
      !attention_shape_ok(seq, width, heads, dtype)) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
#define IRT_ARGS(T)                                                                 \
  (const T*)x, (T*)out, (const float*)ln1_s, (const float*)ln1_b,                  \
      (const int8_t*)wqkv_t, (const float*)wqkv_s, (const float*)bqkv,             \
      (const int8_t*)wo_t, (const float*)wo_s, (const float*)bo,                   \
      (const float*)ln2_s, (const float*)ln2_b, (const int8_t*)w1_t,               \
      (const float*)w1_s, (const float*)b1, (const int8_t*)w2_t,                   \
      (const float*)w2_s, (const float*)b2, workspace, batch, seq, width,          \
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
