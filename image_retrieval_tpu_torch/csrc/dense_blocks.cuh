// Plain C interface of the Hopper transformer-layer kernels in the compute
// type (layer_block.cu, attention_block.cu, attention_block_train.cu,
// mlp_block.cu, multihead_attention.cu). Bound from Python with ctypes
// (image_retrieval_tpu_torch/ops/_build.py): every pointer and the stream
// are passed as void*, sizes as int.
//
// x/out: (batch, seq, width) in the compute type (dtype 0 = bf16, 1 = f32).
// Weight matrices are in the compute type, output-major (N, K); biases and
// LayerNorm parameters f32. Each call is enqueued on `stream` and returns
// cudaGetLastError() of its launches (0 = ok) or IRT_BAD_ARGS.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

// Bytes of scratch for m = batch * seq token rows.
size_t irt_layer_block_workspace_bytes(int m, int width, int hidden, int elem_bytes);
size_t irt_attention_block_workspace_bytes(int m, int width, int elem_bytes);
size_t irt_mlp_block_workspace_bytes(int m, int width, int hidden, int elem_bytes);

// One pre-LN transformer layer (see layer_block.cu).
int irt_layer_block(
    const void* x, void* out,
    const void* ln1_s, const void* ln1_b, const void* wqkv_t, const void* bqkv,
    const void* wo_t, const void* bo,
    const void* ln2_s, const void* ln2_b, const void* w1_t, const void* b1,
    const void* w2_t, const void* b2,
    void* workspace, int batch, int seq, int width, int hidden, int heads,
    int causal, int dtype, float attn_scale, void* stream);

// Its first half: x + out_proj(MHA(LN1(x))) (see attention_block.cu).
int irt_attention_block(
    const void* x, void* out, const void* ln_s, const void* ln_b,
    const void* wqkv_t, const void* bqkv, const void* wo_t, const void* bo,
    void* workspace, int batch, int seq, int width, int heads, int causal,
    int dtype, float attn_scale, void* stream);

// The same function for training (see attention_block_train.cu): it also
// writes the packed [q | k | v] rows (batch * seq, 3 width) and the attention
// output (batch * seq, width) in the compute type, and the softmax
// probabilities (batch, heads, seq, seq) in f32 before their cast.
size_t irt_attention_block_train_workspace_bytes(int m, int width, int elem_bytes);
int irt_attention_block_train(
    const void* x, void* out, void* qkv, void* attn, void* probs, const void* ln_s,
    const void* ln_b, const void* wqkv_t, const void* bqkv, const void* wo_t, const void* bo,
    void* workspace, int batch, int seq, int width, int heads, int causal, int dtype,
    float attn_scale, void* stream);

// Its second half: x + fc2(quick_gelu(fc1(LN2(x)))) (see mlp_block.cu).
int irt_mlp_block(
    const void* x, void* out, const void* ln_s, const void* ln_b,
    const void* w1_t, const void* b1, const void* w2_t, const void* b2,
    void* workspace, int m, int width, int hidden, int dtype, void* stream);

// Bare multi-head attention on separate contiguous q, k, v (batch, seq,
// width), no mask (see multihead_attention.cu).
int irt_multihead_attention(const void* q, const void* k, const void* v, void* out,
                            int batch, int seq, int width, int heads, int dtype,
                            float attn_scale, void* stream);

// The bf16 attention through the form `route` names (irt_attention_route's
// numbers), rows `ld` elements apart; for timing and tests (see
// multihead_attention.cu).
int irt_attention_as_route(const void* q, const void* k, const void* v, long long ld,
                           void* out, int batch, int seq, int width, int heads, int causal,
                           float attn_scale, int route, void* stream);

#ifdef __cplusplus
}
#endif

#ifndef IRT_BAD_ARGS
#define IRT_BAD_ARGS 100000
#endif
