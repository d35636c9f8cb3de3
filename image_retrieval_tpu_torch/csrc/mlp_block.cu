// Hopper (sm_90a) MLP sub-block in the compute type (bf16 or f32).
//
// Replaces the TPU kernel image_retrieval_tpu/ops/flash_attention.py
// _mlp_block_kernel (l.457, called at l.489 through _pallas_mlp_block and
// mlp_block, l.502): LN2 in f32 cast to the compute type, fc1 with its bias
// kept in f32 through quick_gelu and cast only after it, fc2 and the
// residual add in the compute type. It is the second half of the layer for
// towers wider than 768 (ViT-L/14 vision: width 1024, hidden 4096), for
// inputs whose attention must honour a mask, and under fused_mlp_block.
//
// What bounds it on this card. Per token 16 W^2 flops (16.8 M at W = 1024)
// against 16 W^2 bytes of bf16 weights (16 MB) read once per call: one image
// of 257 tokens is 4.3 GFLOP, so past a few images the call is bound by
// operations. 16 MB of weights is ~74x one SM's shared memory, so the TPU
// design (both matrices resident in VMEM across the image grid) does not
// transfer.
//
// What the design does about it. Three launches of dense_common.cuh's
// kernels: LN + cast (a warp per row), the fc1 GEMM with quick_gelu in f32
// and the cast in its epilogue, and the fc2 GEMM with the residual add in
// its epilogue. Both GEMMs are gemm_sm90.cuh's persistent, clustered one:
// wgmma m64n128k16 fed by TMA through a shared-memory ring that runs ahead
// across tiles, tiles of 128 columns and 64-192 rows by shape, the
// epilogues finishing the accumulators in registers and storing them by TMA
// from shared memory. fc1's epilogue (exp and an IEEE reciprocal an output)
// is the slowest part of the half on an H100 (PERF.md). The hidden
// activation (m x hidden in the compute type) is the largest intermediate
// and passes through device memory (and mostly the 50 MB L2).

#include "dense_blocks.cuh"

#include "dense_common.cuh"

extern "C" {

size_t irt_mlp_block_workspace_bytes(int m, int width, int hidden, int elem_bytes) {
  Carver c(nullptr);
  DenseMlpWorkspace w;
  carve_dense_mlp(c, m, width, hidden, elem_bytes, &w);
  return c.off;
}

int irt_mlp_block(
    const void* x, void* out, const void* ln_s, const void* ln_b,
    const void* w1_t, const void* b1, const void* w2_t, const void* b2,
    void* workspace, int m, int width, int hidden, int dtype, void* stream) {
  if (!dense_shape_ok(m, 1, width, hidden, dtype)) return IRT_BAD_ARGS;
  const cudaStream_t st = (cudaStream_t)stream;
  Carver c(workspace);
  DenseMlpWorkspace w;
  carve_dense_mlp(c, m, width, hidden, dtype == 0 ? 2 : 4, &w);
#define IRT_ARGS(T)                                                              \
  (const T*)x, (T*)out, (const float*)ln_s, (const float*)ln_b, (const T*)w1_t, \
      (const float*)b1, (const T*)w2_t, (const float*)b2, w, m, width, hidden, st
  if (dtype == 0) return run_dense_mlp_block<__nv_bfloat16>(IRT_ARGS(__nv_bfloat16));
  return run_dense_mlp_block<float>(IRT_ARGS(float));
#undef IRT_ARGS
}

}  // extern "C"
