// Hopper (sm_90a) whole transformer layer in the compute type (bf16 or f32).
//
// Replaces the TPU kernel image_retrieval_tpu/ops/flash_attention.py
// _layer_block_kernel (l.931, called at l.981 through _pallas_layer_block and
// layer_block, l.1003): one pre-LN CLIP transformer layer whose six
// projections stay in the compute type, the closer-numerics alternative to
// the int8 layer.
//
// What bounds it on this card. One layer does 24 W^2 flops per token in its
// projections (12 W^2 multiply-adds with hidden = 4 W) against 24 W^2 bytes
// of bf16 weights (14 MB at W = 768) read once per call: from a few
// hundred token rows on the call is bound by operations at the bf16
// tensor-core rate, below that by the weights' bytes and the serial chain of
// launches. The TPU design (all layer weights resident in VMEM across the
// image grid) does not transfer: 14 MB is ~60x one SM's 227 KB of shared
// memory.
//
// What the design does about it. The chain of dense_common.cuh: the
// attention sub-block's four launches, then the MLP sub-block's three, with
// the mid-layer activation x1 kept in the workspace in the compute type, so
// that the two halves run alone (attention_block.cu, mlp_block.cu) compose to
// this layer bit for bit. In bf16 its four projections run on one
// persistent GEMM (gemm_sm90.cuh: clusters of two blocks walk 128-column
// tiles of 64-192 rows, chosen per shape to trim the last wave; TMA feeds a
// ring that the producer keeps filling across tiles, the A tile multicast to
// both blocks; wgmma with f32 sums; the outputs staged in shared memory and
// stored by TMA under the next tile's products), and the two LayerNorms are
// a warp per row that keeps the sums' order of the block per row it
// replaced, so the layer's bits do not depend on the batch. In f32 the
// products are exact f32 FMAs on the CUDA cores, slow and never TF32; the
// attention is attention_sm90.cuh's in bf16. On an H100 at B/32 B = 256 the
// two LayerNorms take 5.5 % of the layer (12 % before), and most of its
// time sits in fc1, whose quick_gelu epilogue (exp and an IEEE reciprocal
// an output) runs with no products beside it, and in fc2 (PERF.md). Fewer
// launches are later work.

#include "dense_blocks.cuh"

#include "dense_common.cuh"

namespace {

template <typename T>
int run_layer(const T* x, T* out, const float* ln1_s, const float* ln1_b, const T* wqkv_t,
              const float* bqkv, const T* wo_t, const float* bo, const float* ln2_s,
              const float* ln2_b, const T* w1_t, const float* b1, const T* w2_t,
              const float* b2, void* workspace, int batch, int seq, int width, int hidden,
              int heads, int causal, float scale, cudaStream_t st) {
  const int m = batch * seq;
  Carver c(workspace);
  DenseAttnWorkspace aw;
  DenseMlpWorkspace mw;
  carve_dense_attn(c, m, width, (int)sizeof(T), &aw);
  T* x1 = (T*)c.take((size_t)m * width * sizeof(T));  // after the attention residual
  carve_dense_mlp(c, m, width, hidden, (int)sizeof(T), &mw);
  IRT_CHECK(run_dense_attn_block<T>(x, x1, ln1_s, ln1_b, wqkv_t, bqkv, wo_t, bo, aw, batch, seq,
                                    width, heads, causal, scale, st));
  return run_dense_mlp_block<T>(x1, out, ln2_s, ln2_b, w1_t, b1, w2_t, b2, mw, m, width, hidden,
                                st);
}

}  // namespace

extern "C" {

size_t irt_layer_block_workspace_bytes(int m, int width, int hidden, int elem_bytes) {
  Carver c(nullptr);
  DenseAttnWorkspace aw;
  DenseMlpWorkspace mw;
  carve_dense_attn(c, m, width, elem_bytes, &aw);
  c.take((size_t)m * width * elem_bytes);
  carve_dense_mlp(c, m, width, hidden, elem_bytes, &mw);
  return c.off;
}

int irt_layer_block(
    const void* x, void* out,
    const void* ln1_s, const void* ln1_b, const void* wqkv_t, const void* bqkv,
    const void* wo_t, const void* bo,
    const void* ln2_s, const void* ln2_b, const void* w1_t, const void* b1,
    const void* w2_t, const void* b2,
    void* workspace, int batch, int seq, int width, int hidden, int heads,
    int causal, int dtype, float attn_scale, void* stream) {
  if (!dense_shape_ok(batch, seq, width, hidden, dtype) ||
      !attention_shape_ok(seq, width, heads, dtype)) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
#define IRT_ARGS(T)                                                                  \
  (const T*)x, (T*)out, (const float*)ln1_s, (const float*)ln1_b, (const T*)wqkv_t, \
      (const float*)bqkv, (const T*)wo_t, (const float*)bo, (const float*)ln2_s,    \
      (const float*)ln2_b, (const T*)w1_t, (const float*)b1, (const T*)w2_t,        \
      (const float*)b2, workspace, batch, seq, width, hidden, heads, causal,        \
      attn_scale, st
  if (dtype == 0) return run_layer<__nv_bfloat16>(IRT_ARGS(__nv_bfloat16));
  return run_layer<float>(IRT_ARGS(float));
#undef IRT_ARGS
}

}  // extern "C"
