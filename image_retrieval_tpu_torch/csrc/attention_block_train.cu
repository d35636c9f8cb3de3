// Hopper (sm_90a) attention sub-block for training: the forward that keeps
// what its hand-written backward needs.
//
// Replaces the TPU kernel image_retrieval_tpu/ops/flash_attention.py
// _attn_block_saved_kernel (l.1051, called at l.1125 through
// _pallas_attention_block_saved under attention_block_train, l.1225): the
// function of _attn_block_kernel (attention_block.cu), x + out_proj(MHA(LN1(x))),
// which also writes q, k, v and the attention output in the compute type and
// the softmax probabilities in f32, before their cast to the compute type.
// The backward (ops/flash_attention.py::attention_block_saved_backward) reads
// them and recomputes nothing but the LayerNorm.
//
// What bounds it on this card. The operations of attention_block.cu, plus
// the extra outputs: 4 B T W values in the compute type and 4 B H T^2 bytes
// of probabilities. At ViT-B/32's shapes and B = 128 (vision T = 50, W = 768,
// 12 heads; text T = 77, W = 512, 8 heads) the probabilities are 15 and 24 MB
// a layer, as much as all other traffic of the call, and the call sits near
// the line between operations and bytes.
//
// What the design does about it. The chain of attention_block.cu, launch for
// launch (LN + cast a warp per row, one q/k/v GEMM and the out-projection
// with the residual add on the persistent, clustered bf16 GEMM of
// gemm_sm90.cuh, the tiled attention), so the sub-block's output is bit for
// bit that kernel's; at the trainer's B = 128 the out-projection takes
// 192-row tiles, 102 cluster tiles in two waves of 66 clusters. The packed [q | k | v] rows and the attention output go to
// tensors of the caller instead of scratch, and the attention is
// instantiated with kSaveProbs: it already holds whole score rows (bf16: in
// registers; f32: in shared memory), so each quotient is stored once, in
// f32, as it is computed, and a causal row's keys it never visits get zeros. The TPU kernel's
// halved image block (its VMEM budget) has no counterpart here.

#include "dense_blocks.cuh"

#include "dense_common.cuh"

extern "C" {

size_t irt_attention_block_train_workspace_bytes(int m, int width, int elem_bytes) {
  return align256((size_t)m * width * elem_bytes);  // the LN1 rows
}

int irt_attention_block_train(
    const void* x, void* out, void* qkv, void* attn, void* probs, const void* ln_s,
    const void* ln_b, const void* wqkv_t, const void* bqkv, const void* wo_t, const void* bo,
    void* workspace, int batch, int seq, int width, int heads, int causal, int dtype,
    float attn_scale, void* stream) {
  if (!dense_shape_ok(batch, seq, width, 64, dtype) ||
      !attention_shape_ok(seq, width, heads, dtype) ||
      qkv == nullptr || attn == nullptr || probs == nullptr) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  DenseAttnWorkspace w;
  w.h = workspace;
  w.qkv = qkv;
  w.attn = attn;
  w.probs = (float*)probs;
#define IRT_ARGS(T)                                                                  \
  (const T*)x, (T*)out, (const float*)ln_s, (const float*)ln_b, (const T*)wqkv_t,   \
      (const float*)bqkv, (const T*)wo_t, (const float*)bo, w, batch, seq, width,   \
      heads, causal, attn_scale, st
  if (dtype == 0) return run_dense_attn_block<__nv_bfloat16>(IRT_ARGS(__nv_bfloat16));
  return run_dense_attn_block<float>(IRT_ARGS(float));
#undef IRT_ARGS
}

}  // extern "C"
