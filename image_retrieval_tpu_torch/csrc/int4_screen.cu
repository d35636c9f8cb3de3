// Hopper (sm_90a) int4 screen: approximate cosine over nibble-packed rows.
//
// Replaces the TPU kernels image_retrieval_tpu/ops/pallas_kernels.py
// _int4_screen_kernel (l.602, K3) and _int4_screen_kernel_i8 (l.636, K12,
// selected at l.751), launched by _int4_screen_scores_halves (l.715,
// pallas_call at l.758) under int4_screen_scores_pallas (l.783) and
// int4_screen_topc_pallas (l.800):
//
//   K3:  score[q, n] = scale4[n] * sum_d bf16(qu[q, d]) * (nibble(packed[n], d) - 8)
//   K12: score[q, n] = scale4[n] * float(sum_d q8[q, d] * (nibble(packed[n], d) - 8))
//
// with f32 accumulation (K3) or an exact int32 sum (K12); rows whose valid
// byte is 0 score -inf. `packed` is the plain (N, D/2) uint8 layout: byte j
// of a row holds dim 2j in its low nibble and dim 2j+1 in its high nibble,
// biased by +8. The TPU kernel's paired 128-lane rows and zero-extended query
// planes exist for its tiling only and are not carried over.
//
// K12's queries are quantized to int8 per query (int4_query_planes_i8, l.664;
// here a plain (Q, D) int8 tensor) and its per-query scale is not applied: it
// is positive, cannot change a query's ranking, and the caller multiplies the
// selected values by it. |sum| <= 127 * 8 * D < 2^24 for D <= 2048, so the
// int32 sum and its conversion to f32 are exact: kernel and plain version
// agree bit for bit. K3's products (bf16 query x nibble in -8..7) are exact
// too, and only the order of its f32 sums differs from the plain version
// (unpack2_dots * scales).
//
// Both entries launch one kernel body, the persistent TMA-ring sweep of
// int4_screen_sm90.cuh, which sets out what bounds it and its design.

#include "int4_screen.cuh"

#include <string.h>

#include "int4_screen_sm90.cuh"

namespace {

// The plan on the current device; false where int4_screen_plan refuses.
bool screen_plan_here(int nq, int d, int rows, long long row_offset, const void* packed, bool i8,
                      Int4ScreenPlan* p) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return false;
  }
  return int4_screen_plan(nq, d, rows, row_offset, (uintptr_t)packed % 16 == 0, i8, sms, p);
}

template <bool kI8, int kNT>
int launch_screen_as(const CUtensorMap& map, const void* qu, const void* packed,
                     const void* scales, const void* valid, void* out, int nq, int d,
                     long long row_offset, int rows, int qvec, const Int4ScreenPlan& p,
                     cudaStream_t st) {
  auto kernel = int4_screen_sweep_kernel<kI8, kNT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  IRT_TRY(kernel<<<p.grid, kScThreads, p.smem, st>>>(
      map, qu, (const uint8_t*)packed, (const float*)scales, (const uint8_t*)valid, (float*)out,
      nq, d, row_offset, rows, qvec, p));
  return 0;
}

// One screen launch: the plan, the tensor map over the whole (N, D/2) array
// (rows up to row_offset + rows, the segment's rows a coordinate), and the
// instantiation of the plan's unit width.
template <bool kI8>
int launch_screen(const void* qu, const void* packed, const void* scales, const void* valid,
                  void* out, int nq, int d, long long row_offset, int rows, int qvec,
                  cudaStream_t st) {
  Int4ScreenPlan p;
  if (!screen_plan_here(nq, d, rows, row_offset, packed, kI8, &p)) return IRT_BAD_ARGS;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (p.tma) {
    if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
    // (D/2, row_offset + rows) bytes as boxes of (128 bytes, 256 rows),
    // 128-byte swizzle, zeros past its edges
    const cuuint64_t dims[2] = {(cuuint64_t)(d / 2), (cuuint64_t)(row_offset + rows)};
    const cuuint64_t strides[1] = {(cuuint64_t)(d / 2)};
    const cuuint32_t box[2] = {(cuuint32_t)kScBoxBytes, (cuuint32_t)kScTileRows};
    const cuuint32_t elem[2] = {1, 1};
    if (encode_tiled()(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(packed), dims,
                       strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return IRT_BAD_ARGS;
    }
  }
#define IRT_SCREEN(nt)                                                                       \
  launch_screen_as<kI8, nt>(map, qu, packed, scales, valid, out, nq, d, row_offset, rows, qvec, \
                            p, st)
  switch (p.qw) {
    case 8: return IRT_SCREEN(1);
    case 16: return IRT_SCREEN(2);
    case 32: return IRT_SCREEN(4);
    case 64: return IRT_SCREEN(8);
  }
#undef IRT_SCREEN
  return IRT_BAD_ARGS;
}

}  // namespace

extern "C" int irt_int4_screen_scores(const void* qu, const void* packed, const void* scales,
                                      const void* valid, void* out, int nq, int d,
                                      long long row_offset, int rows, void* stream) {
  if ((uintptr_t)qu % 4) return IRT_BAD_ARGS;
  return launch_screen<false>(qu, packed, scales, valid, out, nq, d, row_offset, rows, 1,
                              (cudaStream_t)stream);
}

extern "C" int irt_int4_screen_scores_i8(const void* qu, const void* packed, const void* scales,
                                         const void* valid, void* out, int nq, int d,
                                         long long row_offset, int rows, void* stream) {
  const int qvec = d % 4 == 0 && (uintptr_t)qu % 4 == 0;
  return launch_screen<true>(qu, packed, scales, valid, out, nq, d, row_offset, rows, qvec,
                             (cudaStream_t)stream);
}

// The screen's launch plan as the kernel would take it: 0 and out[15] = (qw,
// tile_rows, passes, resident, q_rows, q_boxes, q_pitch, boxes, stages,
// stage_bytes, tma, tiles, per_sm, grid, smem), or IRT_BAD_ARGS where the
// kernel refuses the shape.
extern "C" int irt_int4_screen_plan(int nq, int d, int rows, long long row_offset, int aligned,
                                    int i8, int sms, int* out) {
  Int4ScreenPlan p;
  if (!int4_screen_plan(nq, d, rows, row_offset, aligned != 0, i8 != 0, sms, &p)) {
    return IRT_BAD_ARGS;
  }
  const int v[15] = {p.qw,     p.tile_rows,   p.passes, p.resident, p.q_rows,
                     p.q_boxes, p.q_pitch,     p.boxes,  p.stages,   p.stage_bytes,
                     p.tma,     p.tiles,       p.per_sm, p.grid,     p.smem};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}
