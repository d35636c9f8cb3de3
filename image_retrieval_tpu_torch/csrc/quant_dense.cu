// Hopper (sm_90a) int8 dense projection: the port of QuantDense /
// _quant_matmul (image_retrieval_tpu/models/clip.py l.37-110), which the
// JAX package leaves to XLA as an int8 x int8 -> int32 dot_general. Here it
// is the two kernels of int8_common.cuh that the layer kernels are built
// from: a per-row int8 quantization of the input (taken in f32), then the
// int8 GEMM (gemm_sm90.cuh: wgmma fed by TMA) whose epilogue computes
// acc * xscale * wscale + bias in f32 and casts. It serves the routings of
// the model that fuse nothing or only half a layer (int8_matmuls alone, a
// masked vision sequence).
//
// Bound: 2 k n int8 operations per row against k n bytes of weights read
// once; operations past a few hundred rows, the weight read below that.

#include "quant_dense.cuh"

#include "int8_common.cuh"

namespace {

template <typename In, typename Out>
int run_quant_dense(const In* x, Out* out, const int8_t* w_t, const float* w_s,
                    const float* bias, void* workspace, int m, int k, int n, cudaStream_t st) {
  Carver c(workspace);
  int8_t* xq = (int8_t*)c.take((size_t)m * k);
  float* xs = (float*)c.take(m * sizeof(float));
  IRT_CHECK((launch_ln_rowquant<In, false>(x, nullptr, nullptr, xq, xs, m, k, st)));
  return launch_gemm_s8<Out, kStore>(xq, w_t, xs, w_s, bias, nullptr, out, m, n, k, st);
}

}  // namespace

extern "C" {

size_t irt_quant_dense_workspace_bytes(int m, int k) {
  Carver c(nullptr);
  c.take((size_t)m * k);
  c.take(m * sizeof(float));
  return c.off;
}

int irt_quant_dense(const void* x, void* out, const void* w_t, const void* w_s,
                    const void* bias, void* workspace, int m, int k, int n,
                    int in_dtype, int out_dtype, void* stream) {
  if (!block_shape_ok(m, 1, k, n, in_dtype) || (out_dtype != 0 && out_dtype != 1)) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int8_t* w = (const int8_t*)w_t;
  const float* s = (const float*)w_s;
  const float* b = (const float*)bias;
  typedef __nv_bfloat16 bf16;
  if (in_dtype == 0 && out_dtype == 0)
    return run_quant_dense<bf16, bf16>((const bf16*)x, (bf16*)out, w, s, b, workspace, m, k, n, st);
  if (in_dtype == 1 && out_dtype == 0)
    return run_quant_dense<float, bf16>((const float*)x, (bf16*)out, w, s, b, workspace, m, k, n, st);
  if (in_dtype == 0 && out_dtype == 1)
    return run_quant_dense<bf16, float>((const bf16*)x, (float*)out, w, s, b, workspace, m, k, n, st);
  return run_quant_dense<float, float>((const float*)x, (float*)out, w, s, b, workspace, m, k, n, st);
}

}  // extern "C"
