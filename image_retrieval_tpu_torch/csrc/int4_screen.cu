// Hopper (sm_90a) int4 screen: approximate cosine over nibble-packed rows.
//
// Replaces the TPU kernel image_retrieval_tpu/ops/pallas_kernels.py
// _int4_screen_kernel (l.602), launched by _int4_screen_scores_halves
// (l.715, pallas_call at l.758) under int4_screen_scores_pallas (l.783) and
// int4_screen_topc_pallas (l.800):
//
//   score[q, n] = scale4[n] * sum_d bf16(qu[q, d]) * (nibble(packed[n], d) - 8)
//
// with f32 accumulation; rows whose valid byte is 0 score -inf. `packed` is
// the plain (N, D/2) uint8 layout: byte j of a row holds dim 2j in its low
// nibble and dim 2j+1 in its high nibble, biased by +8. The TPU kernel's
// paired 128-lane rows and zero-extended query planes exist for its tiling
// only and are not carried over.
//
// What bounds it on this card. At Q = 1 the read of the packed rows: 256
// bytes per row at D = 512, 0.16 ms per 2^21-row segment at 3.35 TB/s. At
// Q = 64 the f32 score plane the kernel writes is 64 x 4 = 256 bytes per
// row as well, as much as it reads, and the top-c selection reads the plane
// once more after it.
//
// What the design does about it. Simple and right first:
//   * one block of 256 threads (8 warps) per tile of 128 rows; the tile's
//     packed bytes come into shared memory 64 bytes (128 dims) of each row
//     at a time, by 16-byte loads (byte loads when D/2 is not a multiple of
//     16);
//   * queries are taken 64 at a time (four m16 tiles) and staged in shared
//     memory as bf16; their f32 accumulators stay in registers across all
//     of D, so each packed byte is expanded once per 64 queries;
//   * a byte expands in registers into exactly the bf16 pair (dim 2j,
//     dim 2j+1) that one register of an m16n8k16 B fragment holds: the bf16
//     pattern 0x4300 | n is 128 + n, and subtracting 136 leaves n - 8,
//     exactly;
//   * mma.sync m16n8k16 bf16 x bf16 -> f32. Nibble values -8..7 are exact
//     in bf16, so every product is exact and only the order of the f32 sums
//     differs from the plain version (unpack2_dots * scales);
//   * the epilogue multiplies by the row's scale (no FMA contraction) and
//     writes -inf for invalid rows.
// Fusing the top-c selection into the kernel, so that the score plane never
// reaches device memory, wgmma and TMA are later work.
//
// A second entry, irt_int4_screen_scores_i8, replaces _int4_screen_kernel_i8
// (l.636, selected at l.751 of the same file): the same screen with queries
// quantized to int8 per query (int4_query_planes_i8, l.664; here a plain
// (Q, D) int8 tensor, without the TPU's zero-extended planes),
//
//   score[q, n] = scale4[n] * float(sum_d q8[q, d] * (nibble(packed[n], d) - 8))
//
// The per-query scale is not applied: it is positive, cannot change a
// query's ranking, and the caller multiplies the selected values by it. The
// sum is an int32 and exact (|sum| <= 127 * 8 * D < 2^24 for D <= 2048, so
// its conversion to f32 is exact too): kernel and plain version agree bit
// for bit. Same tiling and the same bytes bound as above; two packed bytes
// expand in registers into the four int8 values of one register of an
// mma.sync m16n8k32 s8 x s8 -> s32 B fragment (nibble - 8 by a per-byte
// subtract), and one k step covers 32 dims instead of 16.

#include "int4_screen.cuh"

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kRows = 128;               // gallery rows per block, 16 per warp
constexpr int kQ = 64;                   // queries per pass: four m16 tiles
constexpr int kChunkDims = 128;          // dims staged per step
constexpr int kChunkBytes = kChunkDims / 2;
// Row strides in shared memory. Packed: 80 bytes = 20 words, so the 8 rows
// a B fragment reads fall on 8 distinct banks (20 r mod 32 = 0, 20, 8, 28,
// 16, 4, 24, 12) and rows stay 16-byte aligned. Queries: 136 bf16 = 68
// words (4 mod 32), so the 8 x 4 words of an A fragment load are distinct.
constexpr int kPStride = kChunkBytes + 16;
constexpr int kQStride = kChunkDims + 8;

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One packed byte -> the bf16 pair (lo nibble - 8, hi nibble - 8), the
// lower dim in the low half (the fragment's lower k index).
__device__ __forceinline__ uint32_t expand_byte(uint32_t b) {
  const uint32_t x = 0x43004300u | (b & 0xFu) | ((b & 0xF0u) << 12);
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x), __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two packed bytes (dims 4i .. 4i + 3 in nibble order) -> the four int8
// values nibble - 8, the lowest dim in the lowest byte.
__device__ __forceinline__ uint32_t expand_pair_i8(uint32_t x) {
  const uint32_t y =
      (x & 0x000Fu) | ((x & 0x00F0u) << 4) | ((x & 0x0F00u) << 8) | ((x & 0xF000u) << 12);
  return __vsub4(y, 0x08080808u);
}

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 query rows in shared memory: 144 bytes = 36 words (4 mod 32), so the
// 8 x 4 words of an A fragment load fall on distinct banks.
constexpr int kQStrideI8 = kChunkDims + 16;

// The int8-query screen. qu: (nq, d) int8. `qvec` says that a query row may
// be read by 4-byte words (d % 4 == 0 and an aligned base).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) int4_screen_i8_kernel(
    const int8_t* __restrict__ qu, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, const uint8_t* __restrict__ valid,
    float* __restrict__ out, int nq, int d, long long row_offset, int rows, int qvec) {
  __shared__ __align__(16) uint8_t sp[kRows * kPStride];
  __shared__ __align__(16) int8_t sq[kQ * kQStrideI8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int tile0 = blockIdx.x * kRows;
  const int tile_rows = min(kRows, rows - tile0);
  const int rb = d >> 1;  // packed bytes per row
  const uint8_t* pbase = packed + (size_t)(row_offset + tile0) * rb;
  const int nchunks = (rb + kChunkBytes - 1) / kChunkBytes;

  // 0x88 decodes to zeros, and query dims past D are staged as zeros
  for (int i = tid; i < kRows * kPStride / 4; i += kThreads) {
    reinterpret_cast<uint32_t*>(sp)[i] = 0x88888888u;
  }

  for (int qbase = 0; qbase < nq; qbase += kQ) {
    const int nqt = min(kQ / 16, (nq - qbase + 15) / 16);
    int acc[kQ / 16][2][4];
#pragma unroll
    for (int qt = 0; qt < kQ / 16; ++qt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[qt][nt][j] = 0;

    for (int kc = 0; kc < nchunks; ++kc) {
      const int cb = min(kChunkBytes, rb - kc * kChunkBytes);
      __syncthreads();  // the previous step's fragments are read
      if (kVec) {
        const int per = cb / 16;
        for (int i = tid; i < tile_rows * per; i += kThreads) {
          const int r = i / per, v = i - r * per;
          *reinterpret_cast<uint4*>(sp + r * kPStride + v * 16) =
              *reinterpret_cast<const uint4*>(pbase + (size_t)r * rb + kc * kChunkBytes + v * 16);
        }
      } else {
        for (int i = tid; i < tile_rows * cb; i += kThreads) {
          const int r = i / cb, b = i - r * cb;
          sp[r * kPStride + b] = pbase[(size_t)r * rb + kc * kChunkBytes + b];
        }
      }
      for (int i = tid; i < nqt * 16 * (kChunkDims / 4); i += kThreads) {
        const int qi = i / (kChunkDims / 4), p = i - qi * (kChunkDims / 4);
        const int dim = kc * kChunkDims + 4 * p;
        uint32_t v = 0;
        if (qbase + qi < nq && dim < d) {
          const int8_t* src = qu + (size_t)(qbase + qi) * d + dim;
          if (qvec) {
            v = *reinterpret_cast<const uint32_t*>(src);
          } else {
            for (int b = 0; b < 4 && dim + b < d; ++b) v |= (uint32_t)(uint8_t)src[b] << (8 * b);
          }
        }
        *reinterpret_cast<uint32_t*>(sq + qi * kQStrideI8 + 4 * p) = v;
      }
      __syncthreads();

      const int nks = (2 * cb + 31) / 32;
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t bf[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint8_t* prow = sp + (warp * 16 + nt * 8 + gid) * kPStride + ks * 16;
          bf[nt][0] = expand_pair_i8(*reinterpret_cast<const uint16_t*>(prow + 2 * t));
          bf[nt][1] = expand_pair_i8(*reinterpret_cast<const uint16_t*>(prow + 8 + 2 * t));
        }
#pragma unroll
        for (int qt = 0; qt < kQ / 16; ++qt) {
          if (qt < nqt) {
            const int8_t* qa = sq + (qt * 16 + gid) * kQStrideI8 + ks * 32 + 4 * t;
            uint32_t af[4];
            af[0] = *reinterpret_cast<const uint32_t*>(qa);
            af[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * kQStrideI8);
            af[2] = *reinterpret_cast<const uint32_t*>(qa + 16);
            af[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * kQStrideI8 + 16);
            mma_s8(acc[qt][0], af, bf[0]);
            mma_s8(acc[qt][1], af, bf[1]);
          }
        }
      }
    }

    // Epilogue: the C fragment's places are those of the bf16 kernel.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int r0 = tile0 + warp * 16 + nt * 8 + 2 * t;
      float sc[2];
      bool ok[2], in[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        in[j] = r0 + j < rows;
        sc[j] = in[j] ? scales[row_offset + r0 + j] : 0.f;
        ok[j] = in[j] && valid[row_offset + r0 + j] != 0;
      }
#pragma unroll
      for (int qt = 0; qt < kQ / 16; ++qt) {
        if (qt < nqt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = qbase + qt * 16 + gid + 8 * h;
            if (q < nq) {
              float* orow = out + (size_t)q * rows;
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if (in[j]) {
                  orow[r0 + j] =
                      ok[j] ? __fmul_rn(__int2float_rn(acc[qt][nt][2 * h + j]), sc[j]) : -INFINITY;
                }
              }
            }
          }
        }
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) int4_screen_kernel(
    const __nv_bfloat16* __restrict__ qu, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, const uint8_t* __restrict__ valid,
    float* __restrict__ out, int nq, int d, long long row_offset, int rows) {
  __shared__ __align__(16) uint8_t sp[kRows * kPStride];
  __shared__ __align__(16) __nv_bfloat16 sq[kQ * kQStride];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int tile0 = blockIdx.x * kRows;
  const int tile_rows = min(kRows, rows - tile0);
  const int rb = d >> 1;  // packed bytes per row
  const uint8_t* pbase = packed + (size_t)(row_offset + tile0) * rb;
  const int nchunks = (rb + kChunkBytes - 1) / kChunkBytes;

  // 0x88 decodes to (0, 0): rows past the tile and bytes past D/2 are
  // finite zeros, and the query dims past D are staged as zeros as well.
  for (int i = tid; i < kRows * kPStride / 4; i += kThreads) {
    reinterpret_cast<uint32_t*>(sp)[i] = 0x88888888u;
  }

  for (int qbase = 0; qbase < nq; qbase += kQ) {
    const int nqt = min(kQ / 16, (nq - qbase + 15) / 16);
    float acc[kQ / 16][2][4];
#pragma unroll
    for (int qt = 0; qt < kQ / 16; ++qt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[qt][nt][j] = 0.f;

    for (int kc = 0; kc < nchunks; ++kc) {
      const int cb = min(kChunkBytes, rb - kc * kChunkBytes);
      __syncthreads();  // the previous step's fragments are read
      if (kVec) {
        const int per = cb / 16;
        for (int i = tid; i < tile_rows * per; i += kThreads) {
          const int r = i / per, v = i - r * per;
          *reinterpret_cast<uint4*>(sp + r * kPStride + v * 16) =
              *reinterpret_cast<const uint4*>(pbase + (size_t)r * rb + kc * kChunkBytes + v * 16);
        }
      } else {
        for (int i = tid; i < tile_rows * cb; i += kThreads) {
          const int r = i / cb, b = i - r * cb;
          sp[r * kPStride + b] = pbase[(size_t)r * rb + kc * kChunkBytes + b];
        }
      }
      for (int i = tid; i < nqt * 16 * (kChunkDims / 2); i += kThreads) {
        const int qi = i / (kChunkDims / 2), p = i - qi * (kChunkDims / 2);
        const int dim = kc * kChunkDims + 2 * p;
        uint32_t v = 0;
        if (qbase + qi < nq && dim < d) {
          v = *reinterpret_cast<const uint32_t*>(qu + (size_t)(qbase + qi) * d + dim);
        }
        *reinterpret_cast<uint32_t*>(sq + qi * kQStride + 2 * p) = v;
      }
      __syncthreads();

      const int nks = (2 * cb + 15) / 16;
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t bf[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint8_t* prow = sp + (warp * 16 + nt * 8 + gid) * kPStride + ks * 8;
          bf[nt][0] = expand_byte(prow[t]);
          bf[nt][1] = expand_byte(prow[4 + t]);
        }
#pragma unroll
        for (int qt = 0; qt < kQ / 16; ++qt) {
          if (qt < nqt) {
            const __nv_bfloat16* qa = sq + (qt * 16 + gid) * kQStride + ks * 16 + 2 * t;
            uint32_t af[4];
            af[0] = *reinterpret_cast<const uint32_t*>(qa);
            af[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * kQStride);
            af[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
            af[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * kQStride + 8);
            mma_bf16(acc[qt][0], af, bf[0]);
            mma_bf16(acc[qt][1], af, bf[1]);
          }
        }
      }
    }

    // Epilogue: C fragment (m = query, n = row): c[2h + j] is query
    // gid + 8h, row 2t + j of the n8 tile.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int r0 = tile0 + warp * 16 + nt * 8 + 2 * t;
      float sc[2];
      bool ok[2], in[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        in[j] = r0 + j < rows;
        sc[j] = in[j] ? scales[row_offset + r0 + j] : 0.f;
        ok[j] = in[j] && valid[row_offset + r0 + j] != 0;
      }
#pragma unroll
      for (int qt = 0; qt < kQ / 16; ++qt) {
        if (qt < nqt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = qbase + qt * 16 + gid + 8 * h;
            if (q < nq) {
              float* orow = out + (size_t)q * rows;
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if (in[j]) {
                  orow[r0 + j] = ok[j] ? __fmul_rn(acc[qt][nt][2 * h + j], sc[j]) : -INFINITY;
                }
              }
            }
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int irt_int4_screen_scores(const void* qu, const void* packed, const void* scales,
                                      const void* valid, void* out, int nq, int d,
                                      long long row_offset, int rows, void* stream) {
  if (nq <= 0 || d <= 0 || d % 2 || rows <= 0 || row_offset < 0 ||
      (uintptr_t)qu % 4) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((rows + kRows - 1) / kRows);
  const bool vec = (d / 2) % 16 == 0 && (uintptr_t)packed % 16 == 0;
#define IRT_ARGS                                                                      \
  (const __nv_bfloat16*)qu, (const uint8_t*)packed, (const float*)scales,            \
      (const uint8_t*)valid, (float*)out, nq, d, row_offset, rows
  if (vec) {
    int4_screen_kernel<true><<<grid, kThreads, 0, st>>>(IRT_ARGS);
  } else {
    int4_screen_kernel<false><<<grid, kThreads, 0, st>>>(IRT_ARGS);
  }
#undef IRT_ARGS
  return (int)cudaGetLastError();
}

extern "C" int irt_int4_screen_scores_i8(const void* qu, const void* packed, const void* scales,
                                         const void* valid, void* out, int nq, int d,
                                         long long row_offset, int rows, void* stream) {
  // d <= 2048 keeps |sum| below 2^24: the int32 -> f32 conversion is exact
  if (nq <= 0 || d <= 0 || d % 2 || d > 2048 || rows <= 0 || row_offset < 0) {
    return IRT_BAD_ARGS;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((rows + kRows - 1) / kRows);
  const bool vec = (d / 2) % 16 == 0 && (uintptr_t)packed % 16 == 0;
  const int qvec = d % 4 == 0 && (uintptr_t)qu % 4 == 0;
#define IRT_ARGS                                                                  \
  (const int8_t*)qu, (const uint8_t*)packed, (const float*)scales,               \
      (const uint8_t*)valid, (float*)out, nq, d, row_offset, rows, qvec
  if (vec) {
    int4_screen_i8_kernel<true><<<grid, kThreads, 0, st>>>(IRT_ARGS);
  } else {
    int4_screen_i8_kernel<false><<<grid, kThreads, 0, st>>>(IRT_ARGS);
  }
#undef IRT_ARGS
  return (int)cudaGetLastError();
}
