// The Hopper (sm_90a) GEMMs of gemm_sm90.cuh on their own, for tests and
// timing: the bf16 GEMM with the epilogues of dense_common.cuh, the int8
// GEMM with those of int8_common.cuh, the int8 MLP's fc1 -> quick_gelu ->
// rowquant stage, the row passes (the bf16 chains' LayerNorm cast, the int8
// chains' LayerNorm and rowquant), and the launch plans they follow.
// Nothing on the main path calls these entries; the layer chains launch the
// same kernels through launch_gemm and launch_gemm_s8. It replaces no TPU
// kernel of its own: the JAX package's kernels keep their projections inside
// each layer kernel (image_retrieval_tpu/ops/flash_attention.py).

#include "gemm_sm90.cuh"

#include "dense_common.cuh"
#include "int8_common.cuh"

extern "C" {

// plan: {rows, stages, smem bytes, grid x, grid y, threads, column tiles, row
// tiles, waves} of gemm_tile_plan over `blocks` slots: a grid of blocks
// persistent over the tiles. dtype 0 = bf16 (one column parameter a tile),
// 1 = int8 (two). Returns 0, or IRT_BAD_ARGS for a shape the kernel
// refuses.
int irt_gemm_plan(int m, int n, int k, int dtype, int blocks, int* plan) {
  if (plan == nullptr || (dtype != 0 && dtype != 1)) return IRT_BAD_ARGS;
  GemmTilePlan p;
  const int params = dtype == 0 ? DenseEpilogueBf16<kBias>::kColParams
                                : Int8Epilogue<__nv_bfloat16, kStore>::kColParams;
  if (!gemm_tile_plan(m, n, k, blocks, params, &p)) return IRT_BAD_ARGS;
  const int out[9] = {p.rows,    p.stages,    p.smem,      p.blocks, 1,
                      p.threads, p.col_tiles, p.row_tiles, p.waves};
  for (int i = 0; i < 9; ++i) plan[i] = out[i];
  return 0;
}

// The blocks of the GEMM the card holds at once for dtype 0 = bf16 or 1 =
// int8 (the fewest over its block forms): the `blocks` its launches plan
// with. Minus an error code on failure.
int irt_gemm_max_blocks(int dtype) {
  if (dtype == 0) return gemm_slots<__nv_bfloat16, DenseEpilogueBf16<kBias>>();
  if (dtype == 1) return gemm_slots<int8_t, Int8Epilogue<__nv_bfloat16, kStore>>();
  return -IRT_BAD_ARGS;
}

// h (m, width) = LN(x) cast to x's type, x (m, width) of dtype 0 = bf16, 1
// = f32, gamma and beta (width,) f32: ln_cast_kernel, the LayerNorm pass of
// the compute-type chains (a warp per row).
int irt_ln_cast(const void* x, const void* gamma, const void* beta, void* h, int m, int width,
                int dtype, void* stream) {
  if (!dense_shape_ok(m, 1, width, 64, dtype) || gamma == nullptr || beta == nullptr) {
    return IRT_BAD_ARGS;
  }
  const float *g = (const float*)gamma, *b = (const float*)beta;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_ln_cast<__nv_bfloat16>((const __nv_bfloat16*)x, g, b, (__nv_bfloat16*)h, m,
                                         width, st);
  }
  return launch_ln_cast<float>((const float*)x, g, b, (float*)h, m, width, st);
}

// plan: {fused, cluster, rows, cols, stages, smem bytes, grid x, grid y,
// threads} of the fc1 -> quick_gelu -> rowquant stage for (m, n, k); fused =
// 0 names the two-launch route (the other fields then 0). IRT_BAD_ARGS for a
// shape the int8 GEMM refuses.
int irt_rowquant_gemm_plan(int m, int n, int k, int* plan) {
  RowquantGemmPlan p;
  if (plan == nullptr || !rowquant_gemm_plan(m, n, k, &p)) return IRT_BAD_ARGS;
  const int out[9] = {p.fused, p.cluster, p.rows, p.cols, p.stages,
                      p.smem, p.grid_x, p.grid_y, p.threads};
  for (int i = 0; i < 9; ++i) plan[i] = out[i];
  return 0;
}

// Clusters of the fused stage the card holds at once for (m, n, k)
// (cudaOccupancyMaxActiveClusters), or minus an error code.
int irt_rowquant_gemm_max_clusters(int m, int n, int k) {
  return rowquant_max_clusters<GeluFinish>(m, n, k);
}

// q (m, n) int8, qs (m,) f32 = rowquant(quick_gelu(a (m, k) int8 x bt (n, k)
// int8 as int32, times row_scale (m,) and col_scale (n,), + bias (n,))), by
// the plan's route; workspace: the f32 (m, n) rows on the two-launch route,
// none (null) on the fused one.
int irt_gemm_s8_gelu_rowquant(const void* a, const void* bt, const void* row_scale,
                              const void* col_scale, const void* bias, void* workspace,
                              void* q, void* qs, int m, int n, int k, void* stream) {
  return launch_gemm_s8_gelu_rowquant(
      (const int8_t*)a, (const int8_t*)bt, (const float*)row_scale, (const float*)col_scale,
      (const float*)bias, (float*)workspace, (int8_t*)q, (float*)qs, m, n, k,
      (cudaStream_t)stream);
}

// q (m, width) int8, qs (m,) f32 = rowquant(LN(x)) (ln = 1, gamma and beta
// (width,) f32) or rowquant(x) (ln = 0) for x (m, width) of dtype 0 = bf16,
// 1 = f32: ln_rowquant_kernel, a warp per row.
int irt_ln_rowquant(const void* x, const void* gamma, const void* beta, void* q, void* qs,
                    int m, int width, int dtype, int ln, void* stream) {
  if (!block_shape_ok(m, 1, width, 64, dtype) || (ln && (gamma == nullptr || beta == nullptr))) {
    return IRT_BAD_ARGS;
  }
  const float *g = (const float*)gamma, *b = (const float*)beta;
  int8_t* Q = (int8_t*)q;
  float* S = (float*)qs;
  const cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf16;
  if (dtype == 0) {
    return ln ? launch_ln_rowquant<bf16, true>((const bf16*)x, g, b, Q, S, m, width, st)
              : launch_ln_rowquant<bf16, false>((const bf16*)x, g, b, Q, S, m, width, st);
  }
  return ln ? launch_ln_rowquant<float, true>((const float*)x, g, b, Q, S, m, width, st)
            : launch_ln_rowquant<float, false>((const float*)x, g, b, Q, S, m, width, st);
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
