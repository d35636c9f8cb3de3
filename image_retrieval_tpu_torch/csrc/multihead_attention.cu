// Hopper (sm_90a) bare multi-head self-attention.
//
// Replaces the TPU kernel image_retrieval_tpu/ops/flash_attention.py
// _attn_kernel (l.87, called at l.160 through _pallas_attention and
// multihead_attention, l.171): per image and head, softmax(q k^T / sqrt(hd))
// v on separate (batch, seq, width) q, k and v in the compute type, no mask.
// Scores are f32 sums scaled after the dot, the softmax is f32, the
// probabilities are cast to the compute type, PV is summed in f32 and cast.
//
// What bounds it on this card. 4 T W flops per token against 8 W bytes
// (bf16: q, k, v read, the output written): T / 2 flops a byte, 25 at
// T = 50, far below the card's 295, so the call is bound by bytes; the
// score tensor never leaves the SM.
//
// What the design does about it. It is the attention of block_common.cuh,
// the attention step of every layer kernel of this package, launched with
// three pointers and a row stride of `width` instead of the thirds of
// packed [q | k | v] rows: one device function under two entries. In bf16
// (attention_mma.cuh) one block of four warps per (head, image) stages K and
// V once with 16-byte cp.async copies and keeps the scores in registers;
// QK^T and PV run on the tensor cores (mma.sync, f32 accumulation). The TPU
// kernel packs several images into one score matmul under a block-diagonal
// mask to fill its matrix unit; here the images are independent blocks. In
// f32 the products are exact FMAs on the CUDA cores.

#include "dense_blocks.cuh"

#include "block_common.cuh"

extern "C" {

int irt_multihead_attention(const void* q, const void* k, const void* v, void* out,
                            int batch, int seq, int width, int heads, int dtype,
                            float attn_scale, void* stream) {
  if (batch <= 0 || batch > 65535 || (dtype != 0 && dtype != 1) ||
      !attention_shape_ok(seq, width, heads, dtype)) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    typedef __nv_bfloat16 T;
    return launch_attention<T>((const T*)q, (const T*)k, (const T*)v, (size_t)width, (T*)out,
                               batch, seq, width, heads, 0, attn_scale, st);
  }
  return launch_attention<float>((const float*)q, (const float*)k, (const float*)v,
                                 (size_t)width, (float*)out, batch, seq, width, heads, 0,
                                 attn_scale, st);
}

}  // extern "C"
