// Hopper (sm_90a) int8 MLP sub-block.
//
// Replaces the TPU kernel image_retrieval_tpu/ops/flash_attention.py
// _mlp_block_int8_kernel (l.671, called at l.732 through
// _pallas_mlp_block_int8 and mlp_block_int8, l.745): LN2 in f32, per-row
// int8 quantization, fc1 as an int8 x int8 -> int32 product kept in f32
// through quick_gelu, requantization, the int8 fc2 and the residual add.
// It is the second half of the layer for towers wider than 768 (ViT-L/14
// vision: width 1024, hidden 4096) and for inputs whose attention must
// honour a mask.
//
// What bounds it on this card. Per token 16 W^2 int8 operations (16.8 M at
// W = 1024) against 8 W^2 bytes of weights (8 MB) read once per call: one
// image of 257 tokens is 4.3 G operations, so past a few images the call
// is bound by operations, not bytes. 8 MB of weights is ~37x one SM's
// shared memory, so the TPU design (both matrices resident in VMEM across
// the image grid) does not transfer.
//
// What the design does about it. Three launches of int8_common.cuh's
// kernels: LN + rowquant (a warp per row), fc1 with quick_gelu in f32 and
// the requantization in its epilogue, and the fc2 GEMM with the residual
// add in its epilogue. fc2 is gemm_sm90.cuh's persistent GEMM: wgmma
// m64n128k32 with int32 sums, fed by TMA through a shared-memory ring, a
// producer warp and one consumer warpgroup per 64 rows. fc1 is the clustered
// form of that GEMM (gemm_wgmma_s8_rowquant_kernel): blocks
// of 64 rows x 512 columns, hidden / 512 of them in a thread block cluster,
// exchange their rows' |max| through distributed shared memory, so that the
// f32 hidden activation (m x hidden x 4 bytes, the largest intermediate)
// never reaches device memory; only its int8 rows and their scales do. A
// hidden width no cluster covers (not a multiple of 512, or above 4,096)
// takes four launches, the f32 rows passing through the workspace
// (rowquant_gemm_plan says which).

#include "mlp_block_int8.cuh"

#include "int8_common.cuh"

extern "C" {

size_t irt_mlp_block_int8_workspace_bytes(int m, int width, int hidden) {
  Carver c(nullptr);
  MlpWorkspace w;
  carve_mlp(c, m, width, hidden, &w);
  return c.off;
}

int irt_mlp_block_int8(
    const void* x, void* out, const void* ln_s, const void* ln_b,
    const void* w1_t, const void* w1_s, const void* b1,
    const void* w2_t, const void* w2_s, const void* b2,
    void* workspace, int m, int width, int hidden, int dtype, void* stream) {
  if (!block_shape_ok(m, 1, width, hidden, dtype)) return IRT_BAD_ARGS;
  const cudaStream_t st = (cudaStream_t)stream;
  Carver c(workspace);
  MlpWorkspace w;
  carve_mlp(c, m, width, hidden, &w);
#define IRT_ARGS(T)                                                          \
  (const T*)x, (T*)out, (const float*)ln_s, (const float*)ln_b,             \
      (const int8_t*)w1_t, (const float*)w1_s, (const float*)b1,            \
      (const int8_t*)w2_t, (const float*)w2_s, (const float*)b2, w, m,      \
      width, hidden, st
  if (dtype == 0) return run_mlp_block<__nv_bfloat16>(IRT_ARGS(__nv_bfloat16));
  return run_mlp_block<float>(IRT_ARGS(float));
#undef IRT_ARGS
}

}  // extern "C"
