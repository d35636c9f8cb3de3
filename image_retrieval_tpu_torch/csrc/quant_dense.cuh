// Plain C interface of the Hopper int8 dense projection (quant_dense.cu),
// bound from Python with ctypes: every pointer and the stream are passed as
// void*, sizes as int.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

// Bytes of scratch for m rows of k inputs (the int8 rows and their scales).
size_t irt_quant_dense_workspace_bytes(int m, int k);

// out[m, n] = cast((sum_k xq[m, k] * w_t[n, k]) * xscale[m] * w_s[n] + bias[n])
// with xq, xscale the per-row int8 quantization of x taken in f32.
// x (m, k) of in_dtype, out (m, n) of out_dtype (0 = bf16, 1 = f32); w_t
// (n, k) int8, output-major; w_s, bias f32 (n,). k % 64 == 0, n % 64 == 0.
// Enqueued on `stream`; returns cudaGetLastError() of the launches (0 = ok)
// or IRT_BAD_ARGS.
int irt_quant_dense(const void* x, void* out, const void* w_t, const void* w_s,
                    const void* bias, void* workspace, int m, int k, int n,
                    int in_dtype, int out_dtype, void* stream);

#ifdef __cplusplus
}
#endif

#ifndef IRT_BAD_ARGS
#define IRT_BAD_ARGS 100000
#endif
