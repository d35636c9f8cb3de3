// The int4 screen's sweep for Hopper (sm_90a): one persistent kernel body
// under both C entries of int4_screen.cu (bf16 queries, K3; int8 queries,
// K12), its launch plan, and the per-box work of one consumer warp. The plan
// is mirrored in Python by ops/int4_screen.py::int4_screen_plan.
//
// What bounds it on this card. At Q = 1 the read of the packed rows: 256
// bytes a row at D = 512, 0.16 ms a 2^21-row segment at 3.35 TB/s. At
// Q = 64 the f32 score plane it writes is 256 bytes a row as well, as much
// as it reads; the products (2 Q D a row) stay far below the tensor cores'
// peak at either size.
//
// The design (the structure of K5's sweep, int8_sweep_sm90.cuh):
//   - Persistent blocks: block b takes the row tiles b, b + grid, b + 2 grid,
//     ... of the segment [row_offset, row_offset + rows). A tile is 256 rows,
//     a 32-row unit for each of the eight consumer warps. Two blocks an SM
//     for units of 8 or 16 queries (their 16 warps hide the latency of each
//     warp's loads, expansions and products; chip_smoke.py --k3-variants
//     times one block an SM beside it), one for 32 or 64 (whose 154-158
//     registers a thread two blocks cannot hold).
//   - A ring of stages in dynamic shared memory, each one box of a tile: 256
//     rows x 128 packed bytes (256 dims) under the 128-byte swizzle. One
//     producer warp fills it: TMA (one thread, expect-tx on the stage's
//     `full` mbarrier) from a tensor map over the whole (N, D/2) array whose
//     row extent ends at row_offset + rows, so that no row of the next
//     segment comes in; where the row stride or the base is no TMA operand
//     ((D/2) % 16 != 0, a base off 16 bytes), its 32 lanes copy the box into
//     the same swizzled layout. The consumers hand a stage back through its
//     `empty` mbarrier. Waits are bounded: a wrong parity traps
//     (gemm_sm90.cuh's mbar_wait).
//   - Bytes past the rows' end come in as 0x00, which decodes to (-8, -8),
//     not to zero. The query dims past D are exact zeros in shared memory, so
//     those bytes add exact zeros; rows past the segment are never written.
//   - Queries resident in shared memory (bf16 for K3, int8 for K12), loaded
//     once per block and zero-padded to whole boxes. A warp's unit is 32 rows
//     x qw queries (8, 16, 32 or 64, the fewest that hold Q); more queries
//     than 64 take further passes over the same tile (through L2). Where all
//     passes' queries do not fit beside the ring, the consumers load each
//     pass's queries before it (a window of boxes at a time where even one
//     pass's rows over the whole of D do not fit).
//   - The products on the tensor cores, rows on M and queries on N: mma.sync
//     m16n8k16 bf16 -> f32 (K3) or m16n8k32 s8 -> s32 (K12), one accumulator
//     per output over the whole of D; K3's 64-query units take wgmma
//     m64n64k16 instead, A (the expanded rows) in registers and B (the
//     queries) from shared memory, so that the B fragments' shared loads go
//     and a warpgroup issues one product where its warps issued 32. Lane
//     (g, t) reads word t of a 16-byte chunk (32 dims) of rows g and g + 8;
//     each packed byte is expanded once,
//     by expand_byte into the bf16 pair of dims (2j, 2j + 1), or two bytes by
//     expand_pair_i8 into four int8 dims: exactly one register of the A
//     fragment (a byte permute, a mask and one subtract a register). The B
//     fragment is the same dims of the query: 16 bytes (two k steps) or 8
//     bytes (one k step) of its resident row.
//   - The epilogue: times the row's scale (__fmul_rn), -inf where valid is 0,
//     staged in a per-warp scratch 16 queries at a time, then written as
//     16-byte stores: each query's 32 rows of the unit are 128 contiguous
//     bytes of the (Q, rows) plane (4-byte stores where rows % 4 != 0). The
//     ring keeps loading the next tile meanwhile.
#pragma once

#include "gemm_sm90.cuh"

namespace {

constexpr int kScWarps = 8;                            // consumer warps
constexpr int kScThreads = 32 * kScWarps + 32;         // and one producer warp
constexpr int kScUnitRows = 32;                        // rows of a warp's unit
constexpr int kScTileRows = kScUnitRows * kScWarps;    // rows of a tile (a TMA box's rows)
constexpr int kScBoxBytes = 128;                       // packed bytes of a stage's row
constexpr int kScBoxDims = 2 * kScBoxBytes;            // the dims they hold
constexpr int kScStageBytes = kScTileRows * kScBoxBytes;
constexpr int kScMaxStages = 16;
constexpr int kScAlign = 1024;                         // the 128-byte swizzle's alignment
constexpr int kScEpiQueries = 16;                      // queries of one epilogue round
constexpr int kScEpiPitch = kScUnitRows + 4;           // floats of a query's scratch row

// The launch plan of one screen call (mirrored by ops/int4_screen.py::int4_screen_plan).
struct Int4ScreenPlan {
  int qw;           // queries of a warp's unit: 8, 16, 32 or 64
  int tile_rows;    // rows of a tile: 256
  int passes;       // ceil(nq / qw)
  int resident;     // 1: every pass's queries over the whole of D loaded once per block
  int q_rows;       // query rows in shared memory
  int q_boxes;      // boxes of a query row in shared memory at once
  int q_pitch;      // bytes from one query row to the next
  int boxes;        // boxes of a packed row: ceil(D / 256)
  int stages;       // ring depth
  int stage_bytes;  // tile_rows * 128
  int tma;          // 1: TMA loads; 0: the producer warp copies
  int tiles;        // ceil(rows / tile_rows)
  int per_sm;       // blocks an SM: 2 for units of 8 or 16 queries, else 1
  int grid;         // persistent blocks: min(tiles, per_sm * SMs)
  int smem;         // dynamic shared memory of a block, bytes
};

// Blocks an SM for units of kNT * 8 queries: the kernel's launch bounds.
__host__ __device__ constexpr int screen_blocks_per_sm(int qw) { return qw <= 16 ? 2 : 1; }
// Dynamic shared memory a block may take beside its static barriers.
inline int screen_smem_max(int per_sm) { return IRT_MAX_SMEM / per_sm - 1024; }

__host__ __device__ constexpr int screen_epi_queries(int qw) {
  return qw < kScEpiQueries ? qw : kScEpiQueries;
}
inline int screen_epilogue_bytes(int qw) {
  return kScWarps * screen_epi_queries(qw) * kScEpiPitch * 4;
}
// Units of qw queries whose products run on wgmma: K3's 64-query units.
__host__ __device__ constexpr bool screen_uses_wgmma(bool i8, int qw) { return !i8 && qw == 64; }

// A query row of q_boxes boxes in shared memory. For mma.sync, 64 mod 128
// bytes for bf16 (a B fragment's 16-byte reads of rows g and g + 1 fall in
// one quarter warp) and 32 mod 128 for int8 (8-byte reads, four rows a half
// warp), so that the reads hit distinct banks. For wgmma no padding: the
// rows are 128-byte slices of swizzled K-block tiles (screen_load_queries_wg).
inline int screen_q_row_bytes(int q_boxes, bool i8, int qw) {
  if (screen_uses_wgmma(i8, qw)) return q_boxes * kScBoxDims * 2;
  return i8 ? q_boxes * kScBoxDims + 32 : q_boxes * kScBoxDims * 2 + 64;
}

// The plan for nq queries against `rows` packed rows of d dims from row
// `row_offset` on; `aligned`: the packed base is 16-byte aligned; i8: int8
// queries (K12). False only for a shape neither form takes: nq, rows or d
// below 1, an odd d, a negative offset, or d > 2048 with int8 queries (the
// int32 sum must stay exact in f32).
inline bool int4_screen_plan(int nq, int d, int rows, long long row_offset, bool aligned, bool i8,
                             int sms, Int4ScreenPlan* p) {
  if (nq < 1 || d < 2 || d % 2 || rows < 1 || row_offset < 0 || sms < 1 || (i8 && d > 2048)) {
    return false;
  }
  const int rb = d / 2;
  p->qw = nq <= 8 ? 8 : nq <= 16 ? 16 : nq <= 32 ? 32 : 64;
  p->tile_rows = kScTileRows;
  p->passes = (nq + p->qw - 1) / p->qw;
  p->boxes = (rb + kScBoxBytes - 1) / kScBoxBytes;
  p->stage_bytes = kScStageBytes;
  p->per_sm = screen_blocks_per_sm(p->qw);
  const long long smem_max = screen_smem_max(p->per_sm);
  const long long epi = screen_epilogue_bytes(p->qw);
  const long long room = smem_max - kScAlign - epi - 2LL * kScStageBytes;
  const long long all_q = (long long)p->passes * p->qw;
  if (all_q * screen_q_row_bytes(p->boxes, i8, p->qw) <= room) {
    p->resident = 1;
    p->q_rows = (int)all_q;
    p->q_boxes = p->boxes;
  } else {
    // one pass's rows, over as many boxes as fit (one always does: 64 rows
    // of one box are 36 KB)
    p->resident = 0;
    p->q_rows = p->qw;
    const long long pad = screen_q_row_bytes(0, i8, p->qw);
    const long long fit = (room / p->qw - pad) / (screen_q_row_bytes(1, i8, p->qw) - pad);
    p->q_boxes = (int)(fit < p->boxes ? fit : p->boxes);
  }
  p->q_pitch = screen_q_row_bytes(p->q_boxes, i8, p->qw);
  const long long q_bytes = (long long)p->q_rows * p->q_pitch;
  const long long stages = (smem_max - kScAlign - q_bytes - epi) / kScStageBytes;
  p->stages = (int)(stages < kScMaxStages ? stages : kScMaxStages);
  p->smem = (int)(kScAlign + (long long)p->stages * kScStageBytes + q_bytes + epi);
  // TMA: a 16-byte row stride and base, and row coordinates that fit an int
  p->tma = aligned && rb % 16 == 0 && row_offset + rows <= 0x7FFFFFFFLL;
  p->tiles = (int)(((long long)rows + kScTileRows - 1) / kScTileRows);
  p->grid = p->tiles < p->per_sm * sms ? p->tiles : p->per_sm * sms;
  return true;
}

// ---------------------------------------------------------------------------
// Nibbles into fragments
// ---------------------------------------------------------------------------

// Byte kB of a word w (w4 = w >> 4) -> the bf16 pair (lo nibble - 8, hi
// nibble - 8) of its dims (2j, 2j + 1), the lower dim in the low half (the
// fragment's lower k index). A byte permute puts the byte's low nibble at
// bits 0-3 and its high nibble (the low nibble of w4's byte) at bits 16-19;
// under 0x4300 in each half they are the bf16 values 128 + n, and
// subtracting 136 leaves n - 8, exactly.
template <int kB>
__device__ __forceinline__ uint32_t expand_byte(uint32_t w, uint32_t w4) {
  constexpr uint32_t kSel = kB | kB << 4 | (4 + kB) << 8 | (4 + kB) << 12;
  const uint32_t x = (__byte_perm(w, w4, kSel) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x), __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Bytes kB and kB + 1 of w (w4 = w >> 4: dims 4i .. 4i + 3 in nibble order)
// -> the four int8 values nibble - 8, the lowest dim in the lowest byte. Per
// byte n + 0x78 stays below 0x100 (no carry) and is 0x80 + (n - 8), whose top
// bit flipped is n - 8 in two's complement.
template <int kB>
__device__ __forceinline__ uint32_t expand_pair_i8(uint32_t w, uint32_t w4) {
  constexpr uint32_t kSel = kB | (4 + kB) << 4 | (kB + 1) << 8 | (5 + kB) << 12;
  return ((__byte_perm(w, w4, kSel) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Lane (g, t)'s word of 16-byte chunk c of row r of a unit: word t of the
// chunk, stored at chunk c ^ (r & 7) under the swizzle (the unit starts on a
// multiple of 8 rows): dims 32 c + 8 t .. + 7. For r = g (+ 8, 16, 24) the 32
// lanes hit 32 distinct banks.
__device__ __forceinline__ uint32_t screen_word(const uint8_t* unit, int r, int c, int t) {
  return *reinterpret_cast<const uint32_t*>(unit + r * kScBoxBytes + ((c ^ (r & 7)) << 4) +
                                            4 * t);
}

// One box (256 dims, eight chunks) of a unit's 32 rows against its first
// `live_q` of kNT * 8 queries (`qbox`: the first query's row at the box's
// first dim), bf16 queries. Chunk c's word gives k step 2c from its bytes 0
// and 1 (dims 8t .. 8t + 3 at k = 2t, 2t + 1, 2t + 8, 2t + 9) and k step
// 2c + 1 from bytes 2 and 3; the query's 16 bytes at dim 32 c + 8 t are the
// B fragments of both.
template <int kNT>
__device__ __forceinline__ void screen_box_bf16(const uint8_t* unit, const uint8_t* qbox, int pitch,
                                                int live_q, int g, int t,
                                                float (*acc)[kNT][4]) {
#pragma unroll
  for (int c = 0; c < kScBoxBytes / 16; ++c) {
    uint32_t a[2][2][4];  // [m tile][k step][register]
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint32_t w0 = screen_word(unit, 16 * m + g, c, t);
      const uint32_t w1 = screen_word(unit, 16 * m + g + 8, c, t);
      const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
      a[m][0][0] = expand_byte<0>(w0, h0);
      a[m][0][1] = expand_byte<0>(w1, h1);
      a[m][0][2] = expand_byte<1>(w0, h0);
      a[m][0][3] = expand_byte<1>(w1, h1);
      a[m][1][0] = expand_byte<2>(w0, h0);
      a[m][1][1] = expand_byte<2>(w1, h1);
      a[m][1][2] = expand_byte<3>(w0, h0);
      a[m][1][3] = expand_byte<3>(w1, h1);
    }
    const uint8_t* qc = qbox + 64 * c + 16 * t;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n == 0 || 8 * n < live_q) {
        const uint4 bq = *reinterpret_cast<const uint4*>(qc + (size_t)(8 * n + g) * pitch);
        const unsigned b0[2] = {bq.x, bq.y}, b1[2] = {bq.z, bq.w};
        mma_bf16(acc[0][n], a[0][0], b0);
        mma_bf16(acc[1][n], a[1][0], b0);
        mma_bf16(acc[0][n], a[0][1], b1);
        mma_bf16(acc[1][n], a[1][1], b1);
      }
    }
  }
}

// The same with int8 queries: chunk c's word is one k step of 32 (its low
// half dims 8t .. 8t + 3 at k = 4t .. 4t + 3, its high half dims 8t + 4 ..
// 8t + 7 at k = 16 + 4t ..); the query's 8 bytes at dim 32 c + 8 t are its B
// fragment.
template <int kNT>
__device__ __forceinline__ void screen_box_i8(const uint8_t* unit, const uint8_t* qbox, int pitch,
                                              int live_q, int g, int t, int (*acc)[kNT][4]) {
#pragma unroll
  for (int c = 0; c < kScBoxBytes / 16; ++c) {
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint32_t w0 = screen_word(unit, 16 * m + g, c, t);
      const uint32_t w1 = screen_word(unit, 16 * m + g + 8, c, t);
      const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
      a[m][0] = expand_pair_i8<0>(w0, h0);
      a[m][1] = expand_pair_i8<0>(w1, h1);
      a[m][2] = expand_pair_i8<2>(w0, h0);
      a[m][3] = expand_pair_i8<2>(w1, h1);
    }
    const uint8_t* qc = qbox + 32 * c + 8 * t;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n == 0 || 8 * n < live_q) {
        const uint2 bq = *reinterpret_cast<const uint2*>(qc + (size_t)(8 * n + g) * pitch);
        const uint32_t b[2] = {bq.x, bq.y};
        mma_s8(acc[0][n], a[0], b);
        mma_s8(acc[1][n], a[1], b);
      }
    }
  }
}

// d (64 x 64 per warpgroup, f32: this thread's 32 in mma.sync's C layout, n8
// slice j in d[4 j .. 4 j + 3]) += A (64 x 16 bf16: this warp's 16-row slice
// in its 4 registers, in mma.sync's A layout) * B (16 x 64 bf16, K-major in
// shared memory under the 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_bf16_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keeps a chunk's A registers allocated (unchanged) until here: wgmma reads
// them asynchronously, which the compiler does not see.
__device__ __forceinline__ void screen_hold(uint32_t (*a)[2][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      asm volatile("" ::"r"(a[m][k][0]), "r"(a[m][k][1]), "r"(a[m][k][2]), "r"(a[m][k][3]));
    }
  }
}

// screen_box_bf16 for a 64-query unit on wgmma: m tile m of the unit is this
// warp's 16-row slice of one m64n64k16 product of its warpgroup (rows 16 m +
// {g, g + 8}, the same A registers and accumulator places as mma.sync). `qk`:
// the shared address of the pass's queries in the box's first 64-dim K block,
// `kb_stride` bytes from one K block to the next; k step s of the box is the
// 32-byte slice s % 4 of K block s / 4. A chunk's A registers are read until
// the wait after the next chunk's products: two sets alternate. Every warp of
// the warpgroup takes part (rows past the segment read zeros).
__device__ __forceinline__ void screen_box_bf16_wg(const uint8_t* unit, uint32_t qk, int kb_stride,
                                                   int g, int t, float (*acc)[8][4]) {
  uint32_t a[2][2][2][4];  // [chunk parity][m tile][k step][register]
#pragma unroll
  for (int c = 0; c < kScBoxBytes / 16; ++c) {
    uint32_t(*ac)[2][4] = a[c & 1];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint32_t w0 = screen_word(unit, 16 * m + g, c, t);
      const uint32_t w1 = screen_word(unit, 16 * m + g + 8, c, t);
      const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
      ac[m][0][0] = expand_byte<0>(w0, h0);
      ac[m][0][1] = expand_byte<0>(w1, h1);
      ac[m][0][2] = expand_byte<1>(w0, h0);
      ac[m][0][3] = expand_byte<1>(w1, h1);
      ac[m][1][0] = expand_byte<2>(w0, h0);
      ac[m][1][1] = expand_byte<2>(w1, h1);
      ac[m][1][2] = expand_byte<3>(w0, h0);
      ac[m][1][3] = expand_byte<3>(w1, h1);
    }
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ks = 2 * c + h;
      const uint64_t db = wgmma_desc(qk + (ks >> 2) * kb_stride + 32 * (ks & 3));
#pragma unroll
      for (int m = 0; m < 2; ++m) wgmma_rs_bf16_n64(&acc[m][0][0], ac[m][h], db);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      screen_hold(a[(c - 1) & 1]);
    }
  }
  wgmma_wait<0>();
  screen_hold(a[1]);
  fence_acc(&acc[0][0][0]);
}

// ---------------------------------------------------------------------------
// The stages, the queries and the scores
// ---------------------------------------------------------------------------

// The 32 lanes of the producer warp copy box b of the tile whose first row
// is `row0` into `dst` as TMA would: row r's 16-byte chunk c at chunk
// c ^ (r & 7), zeros past row `end` and past byte rb of a row.
__device__ __forceinline__ void screen_copy_box(uint8_t* dst, const uint8_t* packed, long long row0,
                                                long long end, int rb, int b, int lane) {
  for (int i = lane; i < kScTileRows * 8; i += 32) {
    const int r = i >> 3, c = i & 7;
    const int c0 = b * kScBoxBytes + c * 16;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row0 + r < end) {
      const uint8_t* src = packed + (size_t)(row0 + r) * rb;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (c0 + j < rb) v[j >> 2] |= (uint32_t)src[c0 + j] << (8 * (j & 3));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kScBoxBytes + ((c ^ (r & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Query rows [q0, q0 + count) over dims [dim0, dim0 + dims) into shared rows
// of `pitch` bytes by 4-byte words (two bf16 or four int8 dims), zeros past
// nq and past d. qvec: a query row may be read by words (always for bf16: d
// is even and the base 4-byte aligned). Every consumer thread takes part.
template <bool kI8>
__device__ __forceinline__ void screen_load_queries(uint8_t* sq, const void* qu, int q0, int count,
                                                    int nq, int d, int dim0, int dims, int pitch,
                                                    bool qvec) {
  constexpr int kDims = kI8 ? 4 : 2;  // dims of a word
  const int words = dims / kDims;
  for (int i = threadIdx.x; i < count * words; i += kScWarps * 32) {
    const int r = i / words, w = i - r * words;
    const int q = q0 + r, dim = dim0 + w * kDims;
    uint32_t v = 0;
    if (q < nq && dim < d) {
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(qu) + ((size_t)q * d + dim) * (kI8 ? 1 : 2);
      if (!kI8 || qvec) {
        v = *reinterpret_cast<const uint32_t*>(src);
      } else {
        for (int j = 0; j < 4 && dim + j < d; ++j) v |= (uint32_t)src[j] << (8 * j);
      }
    }
    *reinterpret_cast<uint32_t*>(sq + (size_t)r * pitch + 4 * w) = v;
  }
}

// Query rows [q0, q0 + count) over dims [dim0, dim0 + dims) as wgmma's B:
// per 64-dim K block a tile of `count` rows x 128 bytes under the 128-byte
// swizzle (16-byte chunk j of row r at chunk j ^ (r & 7)), the dims of each
// 16-dim k step in the order screen_box_bf16 gives the A fragments: dim
// 32 c + 8 t + 4 h + 2 b (+ 1) at k step 2 c + h, k = 2 t + 8 b (+ 1). Zeros
// past nq and past d. Every consumer thread takes part, then makes its
// stores visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void screen_load_queries_wg(uint8_t* sq, const __nv_bfloat16* qu,
                                                       int q0, int count, int nq, int d, int dim0,
                                                       int dims) {
  const int words = dims / 2;
  for (int i = threadIdx.x; i < count * words; i += kScWarps * 32) {
    const int r = i / words, dl = 2 * (i - r * words);
    const int q = q0 + r;
    uint32_t v = 0;
    if (q < nq && dim0 + dl < d) {
      v = *reinterpret_cast<const uint32_t*>(qu + (size_t)q * d + dim0 + dl);
    }
    const int ks = 2 * (dl >> 5) + ((dl >> 2) & 1);
    const int off = 32 * (ks & 3) + 4 * ((dl >> 3) & 3) + 16 * ((dl >> 1) & 1);
    *reinterpret_cast<uint32_t*>(sq + (size_t)(ks >> 2) * count * 128 + r * 128 +
                                 (((off >> 4) ^ (r & 7)) << 4) + (off & 15)) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warps alone (named barrier 1; the producer never waits on it).
__device__ __forceinline__ void screen_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kScWarps * 32) : "memory");
}

__device__ __forceinline__ float screen_acc_f32(float v) { return v; }
__device__ __forceinline__ float screen_acc_f32(int v) { return __int2float_rn(v); }

// The unit's scores into the (nq, rows) plane: lane (g, t) holds, for m tile
// m and query slice n, rows g + 16 m (+ 8) and queries 8 n + 2 t (+ 1). Per
// round of kEQ queries the warp parks them, scaled (or -inf), in its scratch
// [query][row], then writes each query's run of the unit's rows: 16 bytes a
// lane where rows % 4 == 0 (`vec`), else a row a lane. sc[i]: the scale of
// row g + 8 i; bit r of vmask: row r of the unit is in the segment and valid.
template <int kNT, typename Acc>
__device__ __forceinline__ void screen_epilogue(Acc (*acc)[kNT][4], float* scratch,
                                                const float* sc, unsigned vmask, float* out,
                                                int q0, int nq, long long row0, int rows, bool vec,
                                                int g, int t, int lane) {
  constexpr int kEQ = screen_epi_queries(8 * kNT);
  constexpr int kNR = kEQ / 8;  // query slices a round
#pragma unroll
  for (int rd = 0; rd < kNT / kNR; ++rd) {
    const int qr = q0 + kEQ * rd;
    if (qr >= nq) break;
#pragma unroll
    for (int nn = 0; nn < kNR; ++nn) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 2 * m + (j >> 1), rl = g + 8 * i;
          const float v = screen_acc_f32(acc[m][kNR * rd + nn][j]);
          scratch[(8 * nn + 2 * t + (j & 1)) * kScEpiPitch + rl] =
              (vmask >> rl) & 1u ? __fmul_rn(v, sc[i]) : -INFINITY;
        }
      }
    }
    __syncwarp();
    if (vec) {
#pragma unroll
      for (int k = 0; k < kEQ / 4; ++k) {
        const int ql = (lane >> 3) + 4 * k, c4 = 4 * (lane & 7);
        if (qr + ql < nq && row0 + c4 < rows) {
          *reinterpret_cast<float4*>(out + (size_t)(qr + ql) * rows + row0 + c4) =
              *reinterpret_cast<const float4*>(scratch + ql * kScEpiPitch + c4);
        }
      }
    } else if (row0 + lane < rows) {
      for (int ql = 0; ql < kEQ && qr + ql < nq; ++ql) {
        out[(size_t)(qr + ql) * rows + row0 + lane] = scratch[ql * kScEpiPitch + lane];
      }
    }
    __syncwarp();  // the scratch is read before the next round writes it
  }
}

// ---------------------------------------------------------------------------
// The sweep
// ---------------------------------------------------------------------------

// Block b walks tiles b, b + grid, ...; per tile and pass, warp w takes the
// unit of rows 32 w .. 32 w + 31 against the pass's qw = 8 kNT queries. The
// producer warp and the consumers walk the same sequence of (tile, pass,
// box) stages.
template <bool kI8, int kNT>
__global__ void __launch_bounds__(kScThreads, screen_blocks_per_sm(8 * kNT))
    int4_screen_sweep_kernel(
    const __grid_constant__ CUtensorMap map, const void* __restrict__ qu,
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    const uint8_t* __restrict__ valid, float* __restrict__ out, int nq, int d,
    long long row_offset, int rows, int qvec, Int4ScreenPlan p) {
  typedef typename std::conditional<kI8, int, float>::type Acc;
  constexpr int kQW = 8 * kNT;
  constexpr bool kWg = screen_uses_wgmma(kI8, kQW);
  constexpr int kElem = kI8 ? 1 : 2;  // bytes of a query value
  extern __shared__ __align__(16) uint8_t screen_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kScMaxStages];  // full[s], then empty[s]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t base = smem_u32(screen_smem);
  const uint32_t ring = (base + kScAlign - 1) & ~(uint32_t)(kScAlign - 1);
  uint8_t* const ring_ptr = screen_smem + (ring - base);
  uint8_t* const sq = ring_ptr + (size_t)p.stages * kScStageBytes;
  float* const scratch = reinterpret_cast<float*>(sq + (size_t)p.q_rows * p.q_pitch) +
                         warp * screen_epi_queries(kQW) * kScEpiPitch;
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[kScMaxStages]);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, p.tma ? 1 : 32);  // the expect-tx arrival, or every copying lane
      mbar_init(empty0 + 8 * s, kScWarps);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kScWarps) {  // the producer
    int s = 0;                // the stage of the next box
    uint32_t phase = 0;       // how often the ring went round, mod 2
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const long long row0 = row_offset + (long long)tile * kScTileRows;
      for (int pass = 0; pass < p.passes; ++pass) {
        for (int b = 0; b < p.boxes; ++b) {
          const uint32_t full = full0 + 8 * s, empty = empty0 + 8 * s;
          // the stage's previous use released; parity 1 passes at once on
          // the first round
          const uint32_t parity = phase ^ 1;
          if (p.tma) {
            if (lane == 0) {
              mbar_wait(empty, parity);
              mbar_arrive_expect_tx(full, kScStageBytes);
              tma_load_2d(ring + s * kScStageBytes, &map, full, b * kScBoxBytes, (int)row0);
            }
          } else {
            mbar_wait(empty, parity);
            screen_copy_box(ring_ptr + (size_t)s * kScStageBytes, packed, row0,
                            row_offset + rows, d / 2, b, lane);
            mbar_arrive(full);
          }
          if (++s == p.stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const bool vec = rows % 4 == 0;
  // the wgmma form's queries: K blocks of q_rows rows, a pass's first row at
  // row q0 of each (resident) or at row 0 (one pass's rows)
  const int kb_stride = p.q_rows * 128;
  if (p.resident) {
    if constexpr (kWg) {
      screen_load_queries_wg(sq, reinterpret_cast<const __nv_bfloat16*>(qu), 0, p.q_rows, nq, d,
                             0, p.q_boxes * kScBoxDims);
    } else {
      screen_load_queries<kI8>(sq, qu, 0, p.q_rows, nq, d, 0, p.q_boxes * kScBoxDims,
                               p.q_pitch, qvec);
    }
    screen_consumers_sync();
  }
  int s = 0;           // the stage of the next box
  uint32_t phase = 0;  // how often the ring went round, mod 2
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * kScTileRows + kScUnitRows * warp;  // in the segment
    const bool active = row0 < rows;  // the same for the whole warp
    // lane l: row row0 + l's scale and valid flag, read here and first used
    // after the tile's boxes, so that their latency hides behind them
    const bool in = row0 + lane < rows;
    const float srow = in ? scales[row_offset + row0 + lane] : 0.f;
    const bool vrow = in && valid[row_offset + row0 + lane] != 0;
    for (int pass = 0; pass < p.passes; ++pass) {
      const int q0 = pass * kQW, live_q = nq - q0;
      Acc acc[2][kNT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][n][j] = 0;
        }
      }
      for (int b = 0; b < p.boxes; ++b) {
        const int wb = b % p.q_boxes;  // the box within the query rows held
        if (!p.resident && wb == 0) {
          screen_consumers_sync();  // every warp is done with the last window
          if constexpr (kWg) {
            screen_load_queries_wg(sq, reinterpret_cast<const __nv_bfloat16*>(qu), q0, kQW, nq,
                                   d, b * kScBoxDims, p.q_boxes * kScBoxDims);
          } else {
            screen_load_queries<kI8>(sq, qu, q0, kQW, nq, d, b * kScBoxDims,
                                     p.q_boxes * kScBoxDims, p.q_pitch, qvec);
          }
          screen_consumers_sync();
        }
        mbar_wait(full0 + 8 * s, phase);
        if constexpr (kWg) {
          const uint8_t* unit =
              ring_ptr + (size_t)s * kScStageBytes + kScUnitRows * warp * kScBoxBytes;
          screen_box_bf16_wg(unit,
                             smem_u32(sq) + (p.resident ? q0 : 0) * 128 + wb * 4 * kb_stride,
                             kb_stride, g, t, acc);
        } else if (active) {
          const uint8_t* unit =
              ring_ptr + (size_t)s * kScStageBytes + kScUnitRows * warp * kScBoxBytes;
          const uint8_t* qbox = sq + (size_t)(p.resident ? q0 : 0) * p.q_pitch +
                                (size_t)wb * kScBoxDims * kElem;
          if constexpr (kI8) {
            screen_box_i8<kNT>(unit, qbox, p.q_pitch, live_q, g, t, acc);
          } else {
            screen_box_bf16<kNT>(unit, qbox, p.q_pitch, live_q, g, t, acc);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
        if (++s == p.stages) {
          s = 0;
          phase ^= 1;
        }
      }
      if (active) {
        // lane (g, t) scores rows g + 8 i
        const unsigned vmask = __ballot_sync(0xffffffffu, vrow);
        float sc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i] = __shfl_sync(0xffffffffu, srow, g + 8 * i);
        screen_epilogue<kNT>(acc, scratch, sc, vmask, out, q0, nq, row0, rows, vec, g, t, lane);
      }
    }
  }
}

}  // namespace
