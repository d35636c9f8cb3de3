// Plain C interface of the Hopper int8 MLP sub-block (mlp_block_int8.cu),
// bound from Python with ctypes: every pointer and the stream are passed as
// void*, sizes as int.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

// Bytes of scratch the sub-block needs for m token rows.
size_t irt_mlp_block_int8_workspace_bytes(int m, int width, int hidden);

// out = x + fc2(rowquant(quick_gelu_f32(fc1(rowquant(LN(x)))))), int8
// projections. x/out: (m, width) in the compute type (dtype 0 = bf16,
// 1 = f32). w1_t (hidden, width) and w2_t (width, hidden) int8,
// output-major; scales/biases f32. Enqueued on `stream`; returns
// cudaGetLastError() of the launches (0 = ok) or IRT_BAD_ARGS.
int irt_mlp_block_int8(
    const void* x, void* out, const void* ln_s, const void* ln_b,
    const void* w1_t, const void* w1_s, const void* b1,
    const void* w2_t, const void* w2_s, const void* b2,
    void* workspace, int m, int width, int hidden, int dtype, void* stream);

#ifdef __cplusplus
}
#endif

#ifndef IRT_BAD_ARGS
#define IRT_BAD_ARGS 100000
#endif
