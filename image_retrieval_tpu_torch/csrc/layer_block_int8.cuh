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

// The launch plan of the attention step of every layer kernel here, in the
// compute type (dtype 0 = bf16, 1 = f32), for `pairs` = batch * heads
// (image, head) pairs; ops/flash_attention.py::attention_plan mirrors it.
// Query rows one block takes (a multiple of 16 in bf16; route 4: the 64-row
// tiles of one work item, which persistent blocks walk), 0 when the shape
// is refused: head_dim not a multiple of 4 or above 128, or the
// (image, head)'s K and V not fitting in shared memory beside one query
// tile.
int irt_attention_tile_rows(int seq, int head_dim, int dtype, int pairs);

// Dynamic shared memory of one attention block at that plan.
size_t irt_attention_smem_bytes(int seq, int head_dim, int dtype);

// The kernel form: 0 the f32 kernel on the CUDA cores; bf16 on the tensor
// cores: 4 wgmma fed by TMA (81-288 keys at head_dim 64), or on mma.sync
// with the scores computed once, 1 (up to 80 keys) or 2 (up to 288 at
// head_dim < 64), or 3 in three passes over 80-key chunks.
int irt_attention_route(int seq, int head_dim, int dtype);

// Adds to *mismatches (one uint64 on the device) the count of quotients of
// n pseudo-random pairs in the attention's range where its branch-free
// division differs from __fdiv_rn; a self-check for the tests.
int irt_attention_division_check(void* mismatches, long long n, void* stream);

// Adds to *mismatches the count of n pseudo-random u <= 0 where the wgmma
// attention's exponential (expf's sequence with the scale 1/8 moved into
// its constants) differs from expf(u / 8); a self-check for the tests.
int irt_attention_exp_check(void* mismatches, long long n, void* stream);

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
