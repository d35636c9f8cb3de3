// Plain C interface of the Hopper int8 attention sub-block
// (attention_block_int8.cu), bound from Python with ctypes: every pointer
// and the stream are passed as void*, sizes as int.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

// Bytes of scratch the sub-block needs for m = batch * seq token rows.
size_t irt_attention_block_int8_workspace_bytes(int m, int width, int elem_bytes);

// out = x + out_proj(MHA(qkv_proj(rowquant(LN(x))))), int8 projections.
// x/out: (batch, seq, width) in the compute type (dtype 0 = bf16, 1 = f32).
// wqkv_t (3 width, width) and wo_t (width, width) int8, output-major;
// scales/biases f32. Enqueued on `stream`; returns cudaGetLastError() of
// the launches (0 = ok) or IRT_BAD_ARGS.
int irt_attention_block_int8(
    const void* x, void* out, const void* ln_s, const void* ln_b,
    const void* wqkv_t, const void* wqkv_s, const void* bqkv,
    const void* wo_t, const void* wo_s, const void* bo,
    void* workspace, int batch, int seq, int width, int heads, int causal,
    int dtype, float attn_scale, void* stream);

// The tiled attention alone, on a packed (batch * seq, 3 width) [q | k | v]
// tensor of the compute type; out (batch * seq, width).
int irt_attention(const void* qkv, void* out, int batch, int seq, int width,
                  int heads, int causal, int dtype, float attn_scale, void* stream);

#ifdef __cplusplus
}
#endif

#ifndef IRT_BAD_ARGS
#define IRT_BAD_ARGS 100000
#endif
