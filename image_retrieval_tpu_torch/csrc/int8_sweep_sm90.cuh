// The int8 weighted sweep of K5 (fused_metrics.cu, optimized_scores_int8_kernel)
// for Hopper (sm_90a): its launch plan, the ring that brings the rows in, and
// the per-box work of one consumer warp. Mirrored in Python by
// ops/fused_metrics.py::int8_sweep_plan.
//
// What bounds K5 on this card. Per (query, row, dim) the product (tensor-core
// work) and, where L1 or Linf is live, a bf16 difference, its |.|, the L1 add
// (tensor-core work here) and the Linf max; per row 768 bytes once. At Q = 1
// the rows' bytes bound it; from a few queries on, the per-element work of a
// live L1/Linf: one bf16x2 fma and one sign-clearing logic operation (at half
// the issue rate) per two elements.
//
// The design.
//   - Persistent blocks, one an SM: block b takes the row tiles b, b + grid,
//     b + 2 grid, ... A tile is 32 * 8 / groups rows.
//   - A ring of stages in dynamic shared memory, each one 128-dim box of a
//     tile (tile rows x 128 bytes, under the 128-byte swizzle). One producer
//     warp fills it: TMA (one thread, expect-tx on the stage's `full`
//     mbarrier, zero fill past the last row and past d) where the rows'
//     stride and base allow it (d % 16 == 0, a 16-byte-aligned base); else its
//     32 lanes copy the box themselves, byte by byte, into the same swizzled
//     layout with zeros past the edges. Eight consumer warps read every stage
//     and hand it back through its `empty` mbarrier. Waits are bounded: a
//     wrong parity traps (gemm_sm90.cuh's mbar_wait).
//   - All of a pass's queries stay in shared memory as bf16 rows (the query
//     rounded once), padded to whole boxes with zeros, beside their norms. A
//     warp's unit is 32 rows x kQW queries (8 where L1 or Linf is live, 32
//     where only the product is) over the whole of d, its sums in registers
//     across the boxes: the `groups` query groups of a pass and the tile's
//     8 / groups row units give the 8 warps one unit each, so a row is read
//     once per pass by the warps that share it. More queries than one pass
//     holds take further passes over the same tile (through L2: the tile was
//     just read); where all of them do not fit, the consumers load each
//     pass's queries before it.
//   - The product on the tensor cores: mma.sync m16n8k16 bf16 -> f32, rows on
//     M, queries on N. int8 is exact in bf16, so every product is exact; the
//     k order inside a k-step is a permutation of the dims, the same for A
//     and B. int8 -> bf16 in registers: the low seven bits under a 0x43 byte
//     are 128 + v, the sign bit under a 0xC3 byte is -128 or -256, and one
//     bf16 add of the two is the value (byte permutes and an add, as
//     CUTLASS's numeric_conversion.h does through f32).
//   - The differences in packed bf16x2: the reconstruction
//     bf16(int8 * bf16(scale * mag)) once per row element of the unit (one
//     bf16 fma), shared by the unit's queries; u - q by one bf16 fma (the
//     exact difference rounded once); |.| by clearing the sign bits; Linf by
//     a bf16x2 max. The L1 sum on the tensor cores: an mma of the |u - q|
//     fragments (two queries x eight dims along k) against a selector operand
//     of ones and zeros that sends each query's eight terms to its own
//     column, so each product is exact and the sums are f32 (unpacking the
//     pairs and adding them on the CUDA cores took twice as long).
//   - The mma sums restart every box (128 dims) and are added to f32 totals
//     on the CUDA cores, as the CUDA-core sweep added its per-chunk sums.
//   - The epilogue: a warp parks its unit's sums in a shared scratch, then
//     lane l scores row l of the unit against its queries (weighted<true>,
//     the plain version's operations in its order), 128 contiguous bytes of
//     the (Q, N) plane a query.
#pragma once

#include "fused_metrics.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kSwWarps = 8;                      // consumer warps
constexpr int kSwThreads = 32 * kSwWarps + 32;   // and one producer warp
constexpr int kSwUnitRows = 32;                  // rows of a warp's unit: two m16 tiles
constexpr int kSwBoxDims = 128;                  // dims (bytes) of one stage's rows
constexpr int kSwMaxStages = 16;
constexpr int kSwAlign = 1024;                   // the 128-byte swizzle's alignment
// Dynamic shared memory of one block, at most: the barriers take the rest.
constexpr int kSwSmemMax = IRT_MAX_SMEM - 1024;

// The launch plan of one K5 call (mirrored by ops/fused_metrics.py::int8_sweep_plan).
struct Int8SweepPlan {
  int qw;           // queries of a warp's unit: 8, 16 or 32 (int8_sweep_plan)
  int groups;       // query groups of one pass: 1, 2, 4 or 8
  int tile_rows;    // rows of a tile: 32 * 8 / groups
  int passes;       // ceil(nq / (groups * qw))
  int resident;     // 1: every pass's queries in shared memory at once; 0: one pass's
  int q_rows;       // query rows in shared memory
  int q_pitch;      // bf16 elements from one query row to the next
  int boxes;        // 128-dim boxes of a row
  int stages;       // ring depth
  int stage_bytes;  // tile_rows * 128
  int tma;          // 1: TMA loads; 0: the producer warp copies
  int tiles;        // ceil(n / tile_rows)
  int grid;         // blocks: min(tiles, SMs)
  int smem;         // dynamic shared memory of a block, bytes
};

inline int sw_ceil(long long a, long long b) { return (int)((a + b - 1) / b); }

// A unit's sums on their way to the epilogue: per consumer warp, 32 rows of
// qw + 1 floats (an odd pitch: the lanes of a row-per-lane read hit distinct
// banks) for the product, and with 8-query units (L1 or Linf live) for the
// L1 sum and the Linf max as well.
__host__ __device__ constexpr int sweep_planes(int qw) { return qw == 8 ? 3 : 1; }
inline long long sweep_epilogue_bytes(int qw) {
  return (long long)kSwWarps * kSwUnitRows * (qw + 1) * 4 * sweep_planes(qw);
}

// The plan with units of qw queries: as many query groups a pass as the
// queries need (at most 8, one per consumer warp and row unit); the queries
// padded to whole boxes at a row pitch of 32 mod 128 bytes (the B
// fragments' 8-byte reads of eight query rows then hit distinct banks), with
// their norms. All queries (rounded up to 8: no warp reads a query row past
// them) stay resident where they fit beside the epilogue's scratch and two
// stages; else one pass's, reloaded before each pass; else fewer groups a
// pass. The ring takes what is left, up to 16 stages.
inline bool sweep_plan_as(int qw, int nq, int n, int d, bool aligned, int sms, Int8SweepPlan* p) {
  p->qw = qw;
  p->boxes = sw_ceil(d, kSwBoxDims);
  p->q_pitch = p->boxes * kSwBoxDims + 16;
  const long long q_row_bytes = 2LL * p->q_pitch + 4;  // the bf16 row and its norm
  const long long epi = sweep_epilogue_bytes(qw);
  const int all_q = (nq + 7) / 8 * 8;
  int groups = 1;
  while (groups < kSwWarps && (long long)groups * qw < nq) groups *= 2;
  for (;; groups /= 2) {
    const int tile_rows = kSwUnitRows * (kSwWarps / groups);
    const long long stage = (long long)tile_rows * kSwBoxDims;
    const int pass_q = groups * qw;
    const long long room = kSwSmemMax - kSwAlign - epi - 2 * stage;
    if (all_q * q_row_bytes <= room) {
      p->resident = 1;
      p->q_rows = all_q;
    } else if (pass_q * q_row_bytes <= room) {
      p->resident = 0;
      p->q_rows = pass_q;
    } else if (groups > 1) {
      continue;
    } else {
      return false;
    }
    p->groups = groups;
    p->tile_rows = tile_rows;
    p->passes = sw_ceil(nq, pass_q);
    p->stage_bytes = (int)stage;
    break;
  }
  const long long q_bytes = (long long)p->q_rows * q_row_bytes;
  const long long fit = (kSwSmemMax - kSwAlign - q_bytes - epi) / p->stage_bytes;
  p->stages = (int)(fit < kSwMaxStages ? fit : kSwMaxStages);
  p->smem = (int)(kSwAlign + (long long)p->stages * p->stage_bytes + q_bytes + epi);
  p->tma = aligned && d % 16 == 0;
  p->tiles = sw_ceil(n, p->tile_rows);
  p->grid = p->tiles < sms ? p->tiles : sms;
  return true;
}

// The plan for nq queries against n rows of d int8 values under the live
// weight bits `live` (bit t: weight t); `aligned`: the rows' base is 16-byte
// aligned. Units of 8 queries where L1 or Linf is live (the Linf maxima take
// a register per row and query; 16-query units of L1 ran slower), 32 where
// only the product is (16 if 32 do not fit), else 16: the conversion of a
// row word serves a unit's queries (64-query units spilled: with the
// producer warp, one SM sub-partition holds three warps, so a thread may
// have 168 registers). False for a shape the kernel does
// not take: nq, n or d below 1, or rows so wide that one unit's query rows
// and two stages do not fit.
inline bool int8_sweep_plan(int nq, int n, int d, int live, bool aligned, int sms,
                            Int8SweepPlan* p) {
  if (nq < 1 || n < 1 || d < 1 || sms < 1) return false;
  const bool dot_only = (live & (1 | 4)) && !(live & (2 | 8));
  const int qw = (live & (2 | 8)) ? 8 : dot_only ? 32 : 16;
  return sweep_plan_as(qw, nq, n, d, aligned, sms, p) ||
         (qw == 32 && sweep_plan_as(16, nq, n, d, aligned, sms, p));
}

// ---------------------------------------------------------------------------
// Packed bf16 arithmetic
// ---------------------------------------------------------------------------

constexpr uint32_t kBf16One2 = 0x3F803F80u;     // (1, 1)
constexpr uint32_t kBf16MinusOne2 = 0xBF80BF80u;
constexpr uint32_t kBf16MinusZero2 = 0x80008000u;

// a * b + c per half, the exact result rounded once to bf16 (nearest even).
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Four int8 values (one word, value 0 in the low byte) as two bf16x2: values
// 0 and 1 in `lo`, 2 and 3 in `hi`, the lower index in the low half. Exact:
// (128 + low seven bits) + (-128 - 128 * sign bit) is the value.
__device__ __forceinline__ void s8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t mag = w & 0x7F7F7F7Fu, sgn = w & 0x80808080u;
  lo = bf16x2_fma(__byte_perm(mag, 0x43434343u, 0x4140), kBf16One2,
                  __byte_perm(sgn, 0xC3C3C3C3u, 0x4140));
  hi = bf16x2_fma(__byte_perm(mag, 0x43434343u, 0x4342), kBf16One2,
                  __byte_perm(sgn, 0xC3C3C3C3u, 0x4342));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// ---------------------------------------------------------------------------
// The stages
// ---------------------------------------------------------------------------

// A row value's bits in the low bytes of a word.
__device__ __forceinline__ uint32_t value_bits(int8_t x) { return (uint8_t)x; }
__device__ __forceinline__ uint32_t value_bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }
__device__ __forceinline__ uint32_t value_bits(float x) { return __float_as_uint(x); }

// The 32 lanes of the producer warp copy 128-byte box b of the tile at row0
// of a (n, d) matrix of T into `dst` as TMA would: row r's 16-byte chunk c at
// chunk c ^ (r & 7), zeros past row n and past dim d. K5 (int8 rows) and the
// f32 sweep (f32 or bf16 rows, f32_sweep_sm90.cuh) take it.
template <typename T>
__device__ __forceinline__ void copy_box(uint8_t* dst, const T* rows, int n, int d, int row0,
                                         int tile_rows, int b, int lane) {
  constexpr int kE = 16 / (int)sizeof(T), kPerWord = 4 / (int)sizeof(T);  // values a chunk, a word
  for (int i = lane; i < tile_rows * 8; i += 32) {
    const int r = i >> 3, c = i & 7;
    const int c0 = (b * 8 + c) * kE;
    uint32_t v[4] = {0u, 0u, 0u, 0u};  // all-zero bits are 0 in every row type
    if (row0 + r < n) {
      const T* src = rows + (size_t)(row0 + r) * d;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        if (c0 + j < d) {
          v[j / kPerWord] |= value_bits(src[c0 + j]) << (8 * (int)sizeof(T) * (j % kPerWord));
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((c ^ (r & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Query rows [first, first + count) of q (nq, d) f32 into shared bf16 rows of
// `pitch` elements, rounded to nearest even, and their norms into s_qn; zeros
// past nq and past d up to the last box. Every consumer thread takes part.
__device__ __forceinline__ void load_query_rows(__nv_bfloat16* sq, float* s_qn, const float* q,
                                                const float* qn, int first, int count, int nq,
                                                int d, int boxes, int pitch) {
  const int cols = boxes * kSwBoxDims;
  for (int i = threadIdx.x; i < count * cols; i += kSwWarps * 32) {
    const int r = i / cols, c = i - r * cols;
    const float v = (first + r < nq && c < d) ? q[(size_t)(first + r) * d + c] : 0.f;
    sq[(size_t)r * pitch + c] = __float2bfloat16_rn(v);
  }
  for (int r = threadIdx.x; r < count; r += kSwWarps * 32) {
    s_qn[r] = first + r < nq ? qn[first + r] : 0.f;
  }
}

// The consumer warps alone (named barrier 1; the producer never waits on it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kSwWarps * 32) : "memory");
}

// ---------------------------------------------------------------------------
// One box of one unit
// ---------------------------------------------------------------------------

// The unit's sums: lane (g, t) holds, for m-tile m and query slice nn (8
// queries), the mma C fragment: rows g + 16 m and g + 8 + 16 m, queries
// 8 nn + 2 t and + 1. lin[i][j]: the running Linf of row g + 8 i and query j
// over the lane's dims, two dims to a register.
template <int kQW>
struct SweepAcc {
  float dot[2][kQW / 8][4];
  float l1[2][4];
  uint32_t lin[4][8];
};

// Lane (g, t)'s word of k-step ks of row r of a unit: word t of 16-byte
// chunk ks, at chunk ks ^ (r & 7) = ks ^ g under the swizzle (the 32 lanes
// hit 32 distinct banks): dims 16 ks + 4 t + {0..3}, which stand at k = 2t,
// 2t + 1 (dims +0, +1) and 2t + 8, 2t + 9 (+2, +3) of the product's A and B
// fragments.
__device__ __forceinline__ uint32_t row_word(const uint8_t* unit, int r, int ks, int g, int t) {
  return *reinterpret_cast<const uint32_t*>(unit + r * kSwBoxDims + ((ks ^ g) << 4) + 4 * t);
}

// The product alone for one 128-dim box (8 k-steps of 16 dims) of the unit's
// 32 rows (`unit`: their first row in the stage) and its first `live_q` of
// kQW queries (`qbox`: the first query's row at the box's first dim). One
// m-tile at a time, so that the box's partial sums take 4 kQW / 8 registers
// and not twice that; each row word is converted once for all kQW queries.
// kFull: every query of the unit is live (no n8 slice is skipped).
template <int kQW, bool kFull>
__device__ __forceinline__ void sweep_box_dot(const uint8_t* unit, const __nv_bfloat16* qbox,
                                              int pitch, int live_q, int g, int t,
                                              SweepAcc<kQW>& acc) {
  constexpr int kNG = kQW / 8;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float part[kNG][4];
#pragma unroll
    for (int nn = 0; nn < kNG; ++nn) {
#pragma unroll
      for (int k = 0; k < 4; ++k) part[nn][k] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t lo0, hi0, lo1, hi1;
      s8x4_to_bf16x2(row_word(unit, g + 16 * m, ks, g, t), lo0, hi0);
      s8x4_to_bf16x2(row_word(unit, g + 8 + 16 * m, ks, g, t), lo1, hi1);
      const unsigned a[4] = {lo0, lo1, hi0, hi1};
      const __nv_bfloat16* qk = qbox + ks * 16 + 4 * t;
#pragma unroll
      for (int nn = 0; nn < kNG; ++nn) {
        if (kFull || nn == 0 || 8 * nn < live_q) {
          const uint2 bq = *reinterpret_cast<const uint2*>(qk + (size_t)(8 * nn + g) * pitch);
          const unsigned b[2] = {bq.x, bq.y};
          mma_bf16(part[nn], a, b);
        }
      }
    }
#pragma unroll
    for (int nn = 0; nn < kNG; ++nn) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc.dot[m][nn][k] += part[nn][k];
    }
  }
}

// One box with the L1 sum and/or the Linf max live, for 8 queries (and the
// product where kDot). The L1 mma takes k = (query of a pair, dim slot):
// lane t's slots 2t, 2t + 1 are dims +0, +1 (e = 0) or +2, +3 (e = 1), and
// the selector `sel[pp]` sends pair pp's two queries to columns 2 pp and
// 2 pp + 1. kFull: all 8 queries live (no pair is skipped).
template <bool kDot, bool kL1, bool kLinf, bool kFull>
__device__ __forceinline__ void sweep_box_diff(const uint8_t* unit, const __nv_bfloat16* qbox,
                                               int pitch, int live_q, int g, int t,
                                               const uint32_t* rs2, uint32_t (*sel)[2],
                                               SweepAcc<8>& acc) {
  float pdot[2][4], pl1[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int k = 0; k < 4; ++k) pdot[m][k] = pl1[m][k] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t x[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s8x4_to_bf16x2(row_word(unit, g + 8 * i, ks, g, t), x[i][0], x[i][1]);
    }
    const __nv_bfloat16* qk = qbox + ks * 16 + 4 * t;
    if constexpr (kDot) {
      const uint2 bq = *reinterpret_cast<const uint2*>(qk + (size_t)g * pitch);
      const unsigned b[2] = {bq.x, bq.y};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const unsigned a[4] = {x[2 * m][0], x[2 * m + 1][0], x[2 * m][1], x[2 * m + 1][1]};
        mma_bf16(pdot[m], a, b);
      }
    }
    uint32_t u[4][2], qv[8][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) u[i][e] = bf16x2_fma(x[i][e], rs2[i], kBf16MinusZero2);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint2 v = *reinterpret_cast<const uint2*>(qk + (size_t)j * pitch);
      qv[j][0] = v.x;
      qv[j][1] = v.y;
    }
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      if (kFull || pp == 0 || 2 * pp < live_q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t a[4][2];  // |u - q| of row g + 8 i against queries 2 pp and 2 pp + 1
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              a[i][h] = bf16x2_fma(qv[2 * pp + h][e], kBf16MinusOne2, u[i][e]) & 0x7FFF7FFFu;
              if constexpr (kLinf) {
                acc.lin[i][2 * pp + h] = bf16x2_max(acc.lin[i][2 * pp + h], a[i][h]);
              }
            }
          }
          if constexpr (kL1) {
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const unsigned af[4] = {a[2 * m][0], a[2 * m + 1][0], a[2 * m][1], a[2 * m + 1][1]};
              mma_bf16(pl1[m], af, sel[pp]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kDot) acc.dot[m][0][k] += pdot[m][k];
      if constexpr (kL1) acc.l1[m][k] += pl1[m][k];
    }
  }
}

// Lane t's Linf of row g + 8 i and queries 2 t + c (c = 0, 1) from the
// unit's running maxima: the larger half, then the largest of the quad.
__device__ __forceinline__ void linf_of_lane(uint32_t (*lin)[8], int t, float (*out)[2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = fmaxf(bf16_lo(lin[i][j]), bf16_hi(lin[i][j]));
      f = fmaxf(f, __shfl_xor_sync(0xffffffffu, f, 1));
      v[j] = fmaxf(f, __shfl_xor_sync(0xffffffffu, f, 2));
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      out[i][c] = t == 0 ? v[c] : t == 1 ? v[2 + c] : t == 2 ? v[4 + c] : v[6 + c];
    }
  }
}

}  // namespace
