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
// What the design does about it. It is the attention of attention_sm90.cuh,
// the attention step of every layer kernel of this package, launched with
// three pointers and a row stride of `width` instead of the thirds of
// packed [q | k | v] rows: one device function under two entries. In bf16
// the scores stay in registers and QK^T and PV run on the tensor cores with
// f32 sums: at 81-288 keys and head_dim 64 (L/14's T = 257) persistent
// blocks fed by TMA run wgmma on 64-row query tiles (attention_sm90.cuh);
// at other shapes warps of 16 rows run mma.sync on K and V staged by
// cp.async (attention_mma.cuh). The TPU kernel packs several images into
// one score matmul under a block-diagonal mask to fill its matrix unit;
// here the images are independent work. In f32 the products are exact FMAs
// on the CUDA cores.

#include "dense_blocks.cuh"

#include "attention_sm90.cuh"

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

// The bf16 attention on separate (batch, seq, width) q, k, v whose rows are
// `ld` elements apart (width for three tensors, 3 width for the thirds of
// packed rows), through the form `route` names (irt_attention_route's
// numbers): the wgmma form where it takes the shape, or the mma.sync form
// the shape would have had without it. Every entry of the main path takes
// the plan's form; this one is for timing the two forms in turns and for
// the card tests. IRT_BAD_ARGS for a form that does not take the shape.
int irt_attention_as_route(const void* q, const void* k, const void* v, long long ld,
                           void* out, int batch, int seq, int width, int heads, int causal,
                           float attn_scale, int route, void* stream) {
  if (batch <= 0 || batch > 65535 || ld < width || !attention_shape_ok(seq, width, heads, 0)) {
    return IRT_BAD_ARGS;
  }
  typedef __nv_bfloat16 T;
  return launch_attention_bf16<false>(route, (const T*)q, (const T*)k, (const T*)v, (size_t)ld,
                                      (T*)out, nullptr, batch, seq, width, heads, causal,
                                      attn_scale, (cudaStream_t)stream);
}

}  // extern "C"
