// Hopper (sm_90a) int8 attention sub-block.
//
// Replaces the TPU kernel image_retrieval_tpu/ops/flash_attention.py
// _attn_block_int8_kernel (l.554, called at l.621 through
// _pallas_attention_block_int8 and attention_block_int8, l.643): LN1 in f32,
// per-row int8 quantization, the q/k/v projections as int8 x int8 -> int32
// products, per-image multi-head attention, requantization, the int8
// out-projection and the residual add. It is the first half of the layer
// for towers wider than 768 (ViT-L/14 vision: 1024 wide, 257 tokens, 16
// heads of 64).
//
// What bounds it on this card. Per token the projections are 8 W^2 int8
// operations and the attention 4 T W bf16 or f32 ones; the int8 weights are 4 W^2
// bytes (4 MB at W = 1024), read once per call. At W = 1024 and T = 257
// one image is 2.2 G int8 operations, so past a few images the call is
// bound by operations, not bytes. The TPU kernel keeps the four weight
// matrices resident in VMEM across its image grid; 4 MB is ~18x one SM's
// shared memory, so that does not transfer.
//
// What the design does about it. Five launches of int8_common.cuh's
// kernels: LN + rowquant, one int8 GEMM (gemm_sm90.cuh: wgmma fed by TMA)
// for q, k and v together
// (per-channel scales make the concatenation bitwise equal to three
// products), the attention of attention_sm90.cuh (bf16: QK^T and PV on the
// tensor cores, K and V of an (image, head) staged once in bf16; f32: query
// rows in tiles of up to 64 beside K and V in shared memory), rowquant, and
// the out-projection GEMM with the residual add in its epilogue. Weights and
// activations pass between launches through L2. One fused launch is later
// work.

#include "attention_block_int8.cuh"

#include "int8_common.cuh"

extern "C" {

size_t irt_attention_block_int8_workspace_bytes(int m, int width, int elem_bytes) {
  Carver c(nullptr);
  AttnWorkspace w;
  carve_attn(c, m, width, elem_bytes, &w);
  return c.off;
}

int irt_attention_block_int8(
    const void* x, void* out, const void* ln_s, const void* ln_b,
    const void* wqkv_t, const void* wqkv_s, const void* bqkv,
    const void* wo_t, const void* wo_s, const void* bo,
    void* workspace, int batch, int seq, int width, int heads, int causal,
    int dtype, float attn_scale, void* stream) {
  if (!block_shape_ok(batch, seq, width, 64, dtype) ||
      !attention_shape_ok(seq, width, heads, dtype)) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  Carver c(workspace);
  AttnWorkspace w;
  carve_attn(c, batch * seq, width, dtype == 0 ? 2 : 4, &w);
#define IRT_ARGS(T)                                                             \
  (const T*)x, (T*)out, (const float*)ln_s, (const float*)ln_b,                \
      (const int8_t*)wqkv_t, (const float*)wqkv_s, (const float*)bqkv,         \
      (const int8_t*)wo_t, (const float*)wo_s, (const float*)bo, w, batch,     \
      seq, width, heads, causal, attn_scale, st
  if (dtype == 0) return run_attn_block<__nv_bfloat16>(IRT_ARGS(__nv_bfloat16));
  return run_attn_block<float>(IRT_ARGS(float));
#undef IRT_ARGS
}

int irt_attention(const void* qkv, void* out, int batch, int seq, int width,
                  int heads, int causal, int dtype, float attn_scale, void* stream) {
  if (batch <= 0 || batch > 65535 || (dtype != 0 && dtype != 1) ||
      !attention_shape_ok(seq, width, heads, dtype)) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_attention_packed<__nv_bfloat16>((const __nv_bfloat16*)qkv, (__nv_bfloat16*)out, batch,
                                           seq, width, heads, causal, attn_scale, st);
  }
  return launch_attention_packed<float>((const float*)qkv, (float*)out, batch, seq, width, heads,
                                 causal, attn_scale, st);
}

}  // extern "C"
