// The Hopper (sm_90a) GEMM of gemm_sm90.cuh on its own, for tests and
// timing: the bf16 GEMM with the epilogues of dense_common.cuh and the int8
// GEMM with those of int8_common.cuh, and the launch plan both follow.
// Nothing on the main path calls these entries; the layer chains launch the
// same kernels through launch_gemm and launch_gemm_s8. It replaces no TPU
// kernel of its own: the JAX package's kernels keep their projections inside
// each layer kernel (image_retrieval_tpu/ops/flash_attention.py).

#include "gemm_sm90.cuh"

#include "dense_common.cuh"
#include "int8_common.cuh"

extern "C" {

// plan: {rows, stages, smem bytes, grid x, grid y, threads}. dtype 0 = bf16,
// 1 = int8. Returns 0, or IRT_BAD_ARGS for a shape the kernel refuses.
int irt_gemm_plan(int m, int n, int k, int dtype, int* plan) {
  GemmPlan p;
  if (plan == nullptr || !gemm_plan(m, n, k, dtype, &p)) return IRT_BAD_ARGS;
  const int out[6] = {p.rows, p.stages, p.smem, p.grid_x, p.grid_y, p.threads};
  for (int i = 0; i < 6; ++i) plan[i] = out[i];
  return 0;
}

// c (m, n) bf16 = epilogue(a (m, k) bf16 x bt (n, k) bf16 + bias (n,) f32):
// epilogue 0 the cast, 1 quick_gelu in f32 then the cast, 2 the cast then
// residual (m, n) bf16 + it in bf16.
int irt_gemm_bf16(const void* a, const void* bt, const void* bias, const void* residual, void* c,
                  int m, int n, int k, int epilogue, void* stream) {
  typedef __nv_bfloat16 bf16;
  const bf16 *A = (const bf16*)a, *B = (const bf16*)bt, *R = (const bf16*)residual;
  const float* b = (const float*)bias;
  bf16* C = (bf16*)c;
  const cudaStream_t st = (cudaStream_t)stream;
  if (epilogue == 0) return launch_gemm<bf16, kBias>(A, B, b, nullptr, C, m, n, k, st);
  if (epilogue == 1) return launch_gemm<bf16, kBiasGelu>(A, B, b, nullptr, C, m, n, k, st);
  if (epilogue == 2 && R != nullptr) {
    return launch_gemm<bf16, kBiasResidual>(A, B, b, R, C, m, n, k, st);
  }
  return IRT_BAD_ARGS;
}

// c (m, n) of out_dtype (0 = bf16, 1 = f32) = epilogue(a (m, k) int8 x
// bt (n, k) int8 as int32, times row_scale (m,) and col_scale (n,), + bias
// (n,), all f32): epilogue 0 the cast, 1 quick_gelu in f32 then the cast, 2
// the cast then residual (m, n) + it in out_dtype.
int irt_gemm_s8(const void* a, const void* bt, const void* row_scale, const void* col_scale,
                const void* bias, const void* residual, void* c, int m, int n, int k,
                int epilogue, int out_dtype, void* stream) {
  const int8_t *A = (const int8_t*)a, *B = (const int8_t*)bt;
  const float *rs = (const float*)row_scale, *cs = (const float*)col_scale,
              *b = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
#define IRT_S8(T)                                                                          \
  if (epilogue == 0) return launch_gemm_s8<T, kStore>(A, B, rs, cs, b, nullptr, (T*)c, m, n, \
                                                      k, st);                              \
  if (epilogue == 1) return launch_gemm_s8<T, kGelu>(A, B, rs, cs, b, nullptr, (T*)c, m, n, \
                                                     k, st);                               \
  if (epilogue == 2 && residual != nullptr) {                                              \
    return launch_gemm_s8<T, kResidual>(A, B, rs, cs, b, (const T*)residual, (T*)c, m, n, k, \
                                        st);                                               \
  }
  if (out_dtype == 0) {
    IRT_S8(__nv_bfloat16)
  } else if (out_dtype == 1) {
    IRT_S8(float)
  }
#undef IRT_S8
  return IRT_BAD_ARGS;
}

}  // extern "C"
