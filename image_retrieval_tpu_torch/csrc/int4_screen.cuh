// Plain C interface of the Hopper int4 screen (int4_screen.cu).
// Bound from Python with ctypes (image_retrieval_tpu_torch/ops/_build.py):
// every pointer and the stream are passed as void*, sizes as int, the row
// offset as long long.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

// Approximate-cosine scores of one segment of a nibble-packed int4 gallery:
//   out[q, r] = scales[o + r] * sum_d qu[q, d] * (nibble(packed[o + r], d) - 8)
// for r < rows, o = row_offset, or -inf where valid[o + r] == 0.
// qu: (nq, d) bf16, 4-byte aligned; packed: (N, d/2) uint8, byte j of a row
// = dim 2j (low nibble) and dim 2j+1 (high nibble), +8 bias; scales: (N,)
// f32; valid: (N,) bytes (0 or 1); out: (nq, rows) f32. d must be even.
// Enqueued on `stream`; returns cudaGetLastError() of the launch (0 = ok)
// or IRT_BAD_ARGS.
int irt_int4_screen_scores(const void* qu, const void* packed, const void* scales,
                           const void* valid, void* out, int nq, int d,
                           long long row_offset, int rows, void* stream);

// The same screen with int8 queries (nq, d), quantized per query by the
// caller, whose positive scale is left out:
//   out[q, r] = scales[o + r] * float(sum_d qu[q, d] * (nibble(packed[o + r], d) - 8))
// The sum is an exact int32; d <= 2048.
int irt_int4_screen_scores_i8(const void* qu, const void* packed, const void* scales,
                              const void* valid, void* out, int nq, int d,
                              long long row_offset, int rows, void* stream);

// The launch plan both entries take for nq queries against `rows` rows of d
// dims from row_offset on (aligned: the packed base is 16-byte aligned; i8:
// int8 queries) on a card of `sms` SMs: 0 and out[15] = (qw, tile_rows,
// passes, resident, q_rows, q_boxes, q_pitch, boxes, stages, stage_bytes,
// tma, tiles, per_sm, grid, smem), or IRT_BAD_ARGS for a shape the kernel
// refuses.
int irt_int4_screen_plan(int nq, int d, int rows, long long row_offset, int aligned, int i8,
                         int sms, int* out);

#ifdef __cplusplus
}
#endif

#ifndef IRT_BAD_ARGS
#define IRT_BAD_ARGS 100000
#endif
