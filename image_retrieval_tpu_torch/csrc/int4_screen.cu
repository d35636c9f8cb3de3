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
