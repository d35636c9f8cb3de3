// Hopper (sm_90a) attention sub-block in the compute type (bf16 or f32).
//
// Replaces the TPU kernel image_retrieval_tpu/ops/flash_attention.py
// _attn_block_kernel (l.346, called at l.380 through _pallas_attention_block
// and attention_block, l.396): LN1 in f32 cast to the compute type, the q, k
// and v projections (f32 sums with their bias, each cast once), per-image
// multi-head attention with an optional causal mask, the out-projection and
// the residual add in the compute type. It is the first half of the layer
// for towers wider than 768 (ViT-L/14 vision: 1024 wide, 257 tokens, 16
// heads of 64) and under fused_attn_block.
//
// What bounds it on this card. Per token the projections are 8 W^2 flops
// and the attention 4 T W; the weights are 8 W^2 bytes in bf16 (8 MB at
// W = 1024), read once per call. At W = 1024 and T = 257 one image is 2.2
// GFLOP of projections, so past a few images the call is bound by
// operations. The TPU kernel keeps the four weight matrices resident in VMEM
// across its image grid; 8 MB is ~37x one SM's shared memory, so that does
// not transfer.
//
// What the design does about it. Four launches of dense_common.cuh's
// kernels: LN + cast (a warp per row, 8 rows a block; the LN of the L/14
// image batch reads and writes 134 MB, a bytes-bound pass), one GEMM for q,
// k and v together (three products over the concatenated output channels),
// the attention of attention_sm90.cuh (whole score rows, because the
// probabilities are rounded to the compute type before PV: in bf16 in
// registers, QK^T and PV on the tensor cores; in f32 in shared memory), and
// the out-projection GEMM with the residual add in its epilogue. In bf16
// both GEMMs are gemm_sm90.cuh's persistent one: a fixed grid of clusters
// of two blocks walks the output tiles, the producer's TMA loads run ahead
// across tile boundaries (the fill of a tile hides under its predecessor's
// epilogue) and the outputs leave by TMA stores; one wgmma shape and one K
// order on every plan keep the bits of a row independent of the batch.
// Weights and activations pass between launches through L2.

#include "dense_blocks.cuh"

#include "dense_common.cuh"

extern "C" {

size_t irt_attention_block_workspace_bytes(int m, int width, int elem_bytes) {
  Carver c(nullptr);
  DenseAttnWorkspace w;
  carve_dense_attn(c, m, width, elem_bytes, &w);
  return c.off;
}

int irt_attention_block(
    const void* x, void* out, const void* ln_s, const void* ln_b,
    const void* wqkv_t, const void* bqkv, const void* wo_t, const void* bo,
    void* workspace, int batch, int seq, int width, int heads, int causal,
    int dtype, float attn_scale, void* stream) {
  if (!dense_shape_ok(batch, seq, width, 64, dtype) ||
      !attention_shape_ok(seq, width, heads, dtype)) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  Carver c(workspace);
  DenseAttnWorkspace w;
  carve_dense_attn(c, batch * seq, width, dtype == 0 ? 2 : 4, &w);
#define IRT_ARGS(T)                                                                  \
  (const T*)x, (T*)out, (const float*)ln_s, (const float*)ln_b, (const T*)wqkv_t,   \
      (const float*)bqkv, (const T*)wo_t, (const float*)bo, w, batch, seq, width,   \
      heads, causal, attn_scale, st
  if (dtype == 0) return run_dense_attn_block<__nv_bfloat16>(IRT_ARGS(__nv_bfloat16));
  return run_dense_attn_block<float>(IRT_ARGS(float));
#undef IRT_ARGS
}

}  // extern "C"
