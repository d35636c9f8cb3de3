// Plain C interface of the Hopper int8 whole-layer kernel chain
// (layer_block_int8.cu). Bound from Python with ctypes
// (image_retrieval_tpu_torch/ops/_build.py): every pointer and the stream
// are passed as void*, sizes as int.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

// Bytes of scratch the layer needs for m = batch * seq token rows.
size_t irt_layer_block_int8_workspace_bytes(int m, int width, int hidden,
                                            int elem_bytes);

// Query rows one attention block takes for (seq, head_dim), chosen so that
// the block's shared memory fits; 0 when the (image, head)'s K and V do not
// fit beside a single query row. The attention of every int8 kernel here.
int irt_attention_tile_rows(int seq, int head_dim);

// Dynamic shared memory of one attention block at that tile.
size_t irt_attention_smem_bytes(int seq, int head_dim);

// One pre-LN transformer layer, int8 projections (see layer_block_int8.cu).
// x/out: (batch, seq, width) in the compute type (dtype 0 = bf16, 1 = f32).
// Int8 matrices are output-major (N, K); scales/biases f32 (N,).
// Enqueued on `stream`; returns cudaGetLastError() of the launches (0 = ok)
// or IRT_BAD_ARGS.
int irt_layer_block_int8(
    const void* x, void* out,
    const void* ln1_s, const void* ln1_b,
    const void* wqkv_t, const void* wqkv_s, const void* bqkv,
    const void* wo_t, const void* wo_s, const void* bo,
    const void* ln2_s, const void* ln2_b,
    const void* w1_t, const void* w1_s, const void* b1,
    const void* w2_t, const void* w2_s, const void* b2,
    void* workspace, int batch, int seq, int width, int hidden, int heads,
    int causal, int dtype, float attn_scale, void* stream);

const char* irt_error_string(int code);

#ifdef __cplusplus
}
#endif

#ifndef IRT_BAD_ARGS
#define IRT_BAD_ARGS 100000
#endif
