// The bf16 attention on mma.sync for the shapes attention_sm90.cuh's wgmma
// form does not take: up to 80 keys (the B/32 towers' T = 50 and 77), 81-288
// keys at a head_dim other than 64, and more than 288 keys. Included by
// attention_sm90.cuh, which dispatches; not a header of its own.
//
// Replaces the TPU kernels' attention at those shapes: _attn_kernel
// (image_retrieval_tpu/ops/flash_attention.py:87, multihead_attention) and
// _inkernel_attention (:258, the attention step of every fused layer
// kernel).
//
// What bounds it on this card. One (image, head) does 4 T^2 hd operations on
// 8 T hd bytes: T / 2 operations a byte, 25 at T = 50, so the bound is
// bytes, and mma.sync at a fraction of the tensor-core peak can meet it.
//
// What the design does about it.
//   * One block of 4 warps (8 for rows of 81-288 keys) per (head, image,
//     group of 16-row query tiles); the groups are only as many as filling
//     the card needs (mma_tiles_per_block). K and V of the (image, head) are
//     staged once in bf16 by cp.async (16-byte copies, 8-byte ones where a
//     head's columns are not 16-byte aligned), rows past the keys and
//     columns past head_dim zero-filled (0 x NaN would poison PV), rows
//     padded by 16 bytes against bank conflicts.
//   * Each warp owns 16 query rows: QK^T and PV on m16n8k16 (ldmatrix, V
//     through ldmatrix.trans), the scores' C fragments masked and reduced
//     across a row's four threads by shuffles, the rounded probabilities
//     PV's A fragments in registers.
//   * Whole score rows, not an online softmax. Up to 80 keys (kResident)
//     one warp holds a tile's scores; 81-288 at head_dim <= 64 two warps
//     of 144 keys each, trading row maxima, sums and PV sums through
//     shared memory (kRouteResidentWide); past that the warp walks 80-key
//     chunks three times (the recomputed scores are the same bits).
//   * No branch inside the unrolled loops; the quotients take div_rn_by,
//     __fdiv_rn's bits without its branch.
//
// Per row the order of operations is the scalar kernel's (block_common.cuh):
// f32 dot over d, __fmul_rn by scale, -inf at masked keys, max,
// expf(__fsub_rn(s, max)), f32 sum, __fdiv_rn, round to bf16, PV summed in
// f32, cast. Only the order of the dot's and the softmax sum's terms
// differs. With kSaveProbs the f32 quotient also goes to `probs` before its
// rounding: whole rows, exact zeros at keys a causal row never visits; the
// flag adds stores only.
#pragma once

#include <algorithm>

namespace {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaChunk = 10;  // n-tiles of 8 keys a warp holds at a time: 80 keys
// Longer rows (up to 288 keys at head_dim <= 64): two warps to a tile, each
// holding 18 n-tiles (144 keys) of scores, in blocks of 8 warps.
constexpr int kMmaHalf = 18;
// Blocks that fill the card: two per SM of 132.
constexpr int kMmaFillBlocks = 2 * 132;

// Which form of the attention takes a shape (the f32 compute type takes
// the scalar kernel, route 0; kRouteWgmma is attention_sm90.cuh's).
enum AttentionRoute { kRouteScalarF32 = 0, kRouteResident = 1, kRouteResidentWide = 2,
                      kRouteThreePass = 3, kRouteWgmma = 4 };

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// head_dim padded to 16, 32, 64 or 128 columns: kD = padded / 16.
inline int mma_kd(int head_dim) {
  return head_dim <= 16 ? 1 : head_dim <= 32 ? 2 : head_dim <= 64 ? 4 : 8;
}

// The mma.sync form of a shape.
inline int mma_route(int seq, int head_dim) {
  const int keys = round16(seq);
  if (keys <= 8 * kMmaChunk) return kRouteResident;
  if (keys <= 2 * 8 * kMmaHalf && head_dim <= 64) return kRouteResidentWide;
  return kRouteThreePass;
}

// Dynamic shared memory of one block: K and V of the (image, head), rows
// padded to 16, and one 16-row Q tile per row group; every row head_dim
// padded to 16 kD columns plus 8. The split form adds, per row group, two
// halves' row maxima and sums and one half's PV fragments in f32.
inline size_t mma_smem_bytes(int seq, int head_dim) {
  const int kd = mma_kd(head_dim);
  const size_t split = mma_route(seq, head_dim) == kRouteResidentWide
                           ? (size_t)kMmaWarps * (2 * 2 * 16 + 2 * kd * 4 * 32) * sizeof(float)
                           : 0;
  return ((size_t)2 * round16(seq) + 16 * kMmaWarps) * (16 * kd + 8) * sizeof(__nv_bfloat16) +
         split;
}

// 16-row query tiles per block for `pairs` (image, head) pairs: every tile
// of a pair in one block, unless that leaves the card short of
// kMmaFillBlocks blocks; then the tiles are split into groups, never so
// many that a block has fewer tiles than warps.
inline int mma_tiles_per_block(int seq, int pairs) {
  const int tiles = (seq + 15) / 16;
  const int want = (kMmaFillBlocks + pairs - 1) / pairs;
  const int groups = std::max(1, std::min(want, (tiles + kMmaWarps - 1) / kMmaWarps));
  return (tiles + groups - 1) / groups;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col), f32: the first k-step, with
// no accumulator to clear.
__device__ __forceinline__ void mma_bf16_first(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// Two f32 values rounded to bf16 (nearest even), the first in the low half:
// the element order of an mma A fragment register.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Rows [0, rows) of one head's columns, `ld` elements apart from `src`, into
// shared rows of 16 kD + 8 elements: rows past `valid` and columns past
// head_dim zero-filled. `wide`: 16-byte copies, else 8-byte ones.
template <int kD>
__device__ __forceinline__ void mma_stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t ld, int rows, int valid, int head_dim,
                                          bool wide, int tid, int nthreads) {
  constexpr int kLd = 16 * kD + 8;
  const int per = wide ? 8 : 4;
  const int per_row = 16 * kD / per;
  for (int idx = tid; idx < rows * per_row; idx += nthreads) {
    const int r = idx / per_row, c = (idx - r * per_row) * per;
    const bool in = r < valid && c < head_dim;
    const __nv_bfloat16* s = in ? src + r * ld + c : src;
    if (wide) {
      cp_async16(dst + r * kLd + c, s, in ? 16 : 0);
    } else {
      cp_async8(dst + r * kLd + c, s, in ? 8 : 0);
    }
  }
}

// The scores of the warp's query rows against keys [j0, j0 + 8 kNT) in C
// fragments: f32 dot on the tensor cores, times scale, -inf at the keys a
// row does not visit. `last[r]`: the last key row r (g, g + 8) visits. No
// branch inside: an n-tile pair at or past `kend` (a multiple of 16, the
// keys of the tile rounded up) reads staged rows below it and is masked
// whole, so the compiler can interleave every n-tile's work. kMin: lowers
// smin[r] to the least scaled score of row r, masked keys included.
template <int kD, int kNT, bool kMin>
__device__ __forceinline__ void mma_scores(float (&s)[kNT][4], const unsigned (&qf)[kD][4],
                                           const __nv_bfloat16* ks, int j0, int kend,
                                           const int (&last)[2], float scale, int lane,
                                           float (&smin)[2]) {
  constexpr int kLd = 16 * kD + 8;
  const int tig = lane & 3;
#pragma unroll
  for (int np = 0; np < kNT / 2; ++np) {
    const int key0 = min(j0 + 16 * np, kend - 16);
    // lanes 0-7 / 8-15 address keys key0.. at columns 0 / 8 of the k-step,
    // lanes 16-31 keys key0 + 8..: b0 b1 of n-tile 2 np, then of 2 np + 1
    const __nv_bfloat16* kp =
        ks + (key0 + (lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kD; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, kp + 16 * kk);
      if (kk == 0) {
        mma_bf16_first(s[2 * np], qf[kk], b);
        mma_bf16_first(s[2 * np + 1], qf[kk], b + 2);
      } else {
        mma_bf16(s[2 * np], qf[kk], b);
        mma_bf16(s[2 * np + 1], qf[kk], b + 2);
      }
    }
  }
  // key j0 + 2 tig + c of n-tile column c = 8 nt + (x & 1), against the row's last
  const int lim[2] = {last[0] - j0 - 2 * tig, last[1] - j0 - 2 * tig};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      // scaled after the dot in f32 (the TPU kernel's order)
      const float v = __fmul_rn(s[nt][x], scale);
      if (kMin) smin[x >> 1] = fminf(smin[x >> 1], v);
      s[nt][x] = 8 * nt + (x & 1) > lim[x >> 1] ? -INFINITY : v;
    }
}

// a / b rounded to nearest, bit for bit __fdiv_rn(a, b), given y =
// __frcp_rn(b), for a = 0 or 2^-90 <= a < 2 and 1 <= b < 2^9 (a softmax
// quotient: a = exp(s - max) <= 1, b = the row's sum, >= 1): q = a y is
// within 1.5 ulps of a / b; one correction with the exact remainder
// a - b q (an fma) makes it faithful, and a second one, by Markstein's
// theorem (y correctly rounded, q faithful), correctly rounded. In that
// range no remainder underflows. Five instructions and no branch, where
// __fdiv_rn branches to a slow path around every quotient.
__device__ __forceinline__ float div_rn_by(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// Step 3 of a tile on the scores of keys [j0, j0 + 8 kNT): p = e / sum into
// s, saved in f32 with kSaveProbs. kExact: by __fdiv_rn, for a tile where
// some exponential lies below div_rn_by's range.
template <int kNT, bool kResident, bool kSaveProbs, bool kExact>
__device__ __forceinline__ void mma_probs(float (&s)[kNT][4], const float (&mx)[2],
                                          const float (&sum)[2], const float (&inv)[2], int j0,
                                          int i0, int seq, int kvw, float* prow, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = x >> 1;
      const float e = kResident ? s[nt][x] : expf(__fsub_rn(s[nt][x], mx[r]));
      s[nt][x] = kExact ? __fdiv_rn(e, sum[r]) : div_rn_by(e, sum[r], inv[r]);
      if (kSaveProbs) {
        const int i = i0 + g + 8 * r, j = j0 + 8 * nt + 2 * tig + (x & 1);
        if (i < seq && j < kvw) prow[(size_t)i * seq + j] = s[nt][x];
      }
    }
  }
}

// Barrier of the two warps that share a row group's tiles (kSplit == 2;
// named barrier group + 1, 64 threads). They trade partial row maxima and
// sums through shared memory across it and combine them in one order, so
// both compute the same bits.
__device__ __forceinline__ void pair_sync(int group) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(group + 1));
}

// q, k, v, out, ld, seq, width, causal, scale as attention_tiled_kernel's.
// Grid (heads, batch, groups of `tiles_per_block` 16-row query tiles);
// 4 kSplit warps: four row groups, each taking the block's tiles in turn,
// and with kSplit == 2 two warps to a tile, each holding the scores of
// half the keys (kNT n-tiles) in registers.
template <int kD, int kNT, bool kResident, bool kSaveProbs, int kSplit>
__global__ void __launch_bounds__(kMmaThreads * kSplit, kSplit) attention_tiled_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, size_t ld, __nv_bfloat16* __restrict__ out,
    float* __restrict__ probs, int seq, int width, int head_dim, int tiles_per_block,
    int causal, float scale, int wide) {
  static_assert(kSplit == 1 || (kSplit == 2 && kResident), "a split tile holds its scores");
  constexpr int kLd = 16 * kD + 8;
  constexpr int kKeys = 8 * kNT;
  extern __shared__ __align__(16) __nv_bfloat16 smb[];
  const int h = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp & (kMmaWarps - 1), half = warp / kMmaWarps;
  const int g = lane >> 2, tig = lane & 3;
  const int t_end = min((seq + 15) >> 4, (int)(blockIdx.z + 1) * tiles_per_block);
  const int kv = causal ? min(seq, 16 * t_end) : seq;  // keys any row of the block visits
  __nv_bfloat16* ks = smb;
  __nv_bfloat16* vs = ks + (size_t)round16(seq) * kLd;
  __nv_bfloat16* qs = vs + (size_t)round16(seq) * kLd + group * 16 * kLd;
  // kSplit == 2: per row group, both halves' row maxima and sums, and the
  // second half's PV fragments
  float* xm = reinterpret_cast<float*>(vs + (size_t)round16(seq) * kLd + kMmaWarps * 16 * kLd) +
              group * 2 * 2 * 16;
  float* xs = xm + 2 * 16;
  float* xo = reinterpret_cast<float*>(vs + (size_t)round16(seq) * kLd + kMmaWarps * 16 * kLd) +
              kMmaWarps * 2 * 2 * 16 + group * 2 * kD * 4 * 32;
  const size_t row0 = (size_t)blockIdx.y * seq;
  const size_t at = row0 * ld + (size_t)h * head_dim;  // the head's first column
  const __nv_bfloat16* qh = q + at;
  float* prow =  // the (image, head)'s (seq, seq) probabilities
      kSaveProbs ? probs + ((size_t)blockIdx.y * gridDim.x + h) * seq * seq : nullptr;
  const int pair_tid = half * 32 + lane;  // the tile's Q rows are staged by its kSplit warps

  mma_stage<kD>(ks, k + at, ld, round16(kv), kv, head_dim, wide, threadIdx.x,
                kMmaThreads * kSplit);
  mma_stage<kD>(vs, v + at, ld, round16(kv), kv, head_dim, wide, threadIdx.x,
                kMmaThreads * kSplit);
  const int first = blockIdx.z * tiles_per_block + group;
  if (first < t_end) {
    mma_stage<kD>(qs, qh + (size_t)16 * first * ld, ld, 16, min(16, seq - 16 * first), head_dim,
                  wide, pair_tid, 32 * kSplit);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int t = first; t < t_end; t += kMmaWarps) {
    if (t != first) {  // the next Q tile, once every lane is done with the last
      if (kSplit == 2) pair_sync(group); else __syncwarp();
      mma_stage<kD>(qs, qh + (size_t)16 * t * ld, ld, 16, min(16, seq - 16 * t), head_dim, wide,
                    pair_tid, 32 * kSplit);
      cp_async_commit();
      cp_async_wait<0>();
      if (kSplit == 2) pair_sync(group); else __syncwarp();
    }
    unsigned qf[kD][4];
#pragma unroll
    for (int kk = 0; kk < kD; ++kk) {
      ldmatrix_x4(qf[kk], qs + (lane & 15) * kLd + 16 * kk + (lane >> 4) * 8);
    }
    const int i0 = 16 * t;
    const int kvw = causal ? min(seq, i0 + 16) : seq;  // keys this tile's rows visit
    const int kend = round16(kvw);
    const int kb = half * kKeys;  // the warp's first key
    const int chunks = kResident ? 1 : (kend + kKeys - 1) / kKeys;
    // the last key rows g and g + 8 visit (keys past it are masked)
    const int last[2] = {causal ? min(i0 + g, seq - 1) : seq - 1,
                         causal ? min(i0 + g + 8, seq - 1) : seq - 1};
    float s[kNT][4];
    float smin[2] = {INFINITY, INFINITY};  // the least scaled score of each row

    // 1. row max (rows g and g + 8 of the tile), over the row's four threads
    // (and the pair); four partial maxima a row for independent chains
    float m4[2][4];
#pragma unroll
    for (int x = 0; x < 8; ++x) m4[x >> 2][x & 3] = -INFINITY;
    for (int c = 0; c < chunks; ++c) {
      mma_scores<kD, kNT, true>(s, qf, ks, kb + c * kKeys, kend, last, scale, lane, smin);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float& m = m4[x >> 1][(x & 1) + 2 * (nt & 1)];
          m = fmaxf(m, s[nt][x]);
        }
      }
    }
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(m4[r][0], m4[r][1]), fmaxf(m4[r][2], m4[r][3]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (kSplit == 2) {
      if (tig == 0) xm[half * 16 + g] = mx[0], xm[half * 16 + g + 8] = mx[1];
      pair_sync(group);
      mx[0] = fmaxf(xm[g], xm[16 + g]);
      mx[1] = fmaxf(xm[g + 8], xm[16 + g + 8]);
    }

    // 2. f32 sum of exp(s - max), four partial sums a row; the resident form
    // keeps the exponentials
    float s4[2][4];
#pragma unroll
    for (int x = 0; x < 8; ++x) s4[x >> 2][x & 3] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (!kResident) {
        mma_scores<kD, kNT, false>(s, qf, ks, kb + c * kKeys, kend, last, scale, lane, smin);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float e = expf(__fsub_rn(s[nt][x], mx[x >> 1]));
          s4[x >> 1][(x & 1) + 2 * (nt & 1)] += e;
          if (kResident) s[nt][x] = e;
        }
      }
    }
    float sum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = (s4[r][0] + s4[r][1]) + (s4[r][2] + s4[r][3]);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    if (kSplit == 2) {
      if (tig == 0) xs[half * 16 + g] = sum[0], xs[half * 16 + g + 8] = sum[1];
      pair_sync(group);
      sum[0] = xs[g] + xs[16 + g];
      sum[1] = xs[g + 8] + xs[16 + g + 8];
    }

    // 3. p = e / sum (saved in f32 with kSaveProbs), rounded to bf16 into
    // PV's A fragments: n-tiles 2 kk and 2 kk + 1 are the 16 keys of k-step
    // kk. __fdiv_rn for a tile where a score lies 62 or more below its row's
    // max: its exponential may fall below div_rn_by's range (2^-90 is
    // exp(-62.38))
    const float inv[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
    const bool exact = __any_sync(0xffffffffu, mx[0] - smin[0] >= 62.f || mx[1] - smin[1] >= 62.f);
    float o[2 * kD][4];
#pragma unroll
    for (int dt = 0; dt < 2 * kD; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int j0 = kb + c * kKeys;
      if (!kResident) mma_scores<kD, kNT, false>(s, qf, ks, j0, kend, last, scale, lane, smin);
      if (exact) {
        mma_probs<kNT, kResident, kSaveProbs, true>(s, mx, sum, inv, j0, i0, seq, kvw, prow,
                                                    lane);
      } else {
        mma_probs<kNT, kResident, kSaveProbs, false>(s, mx, sum, inv, j0, i0, seq, kvw, prow,
                                                     lane);
      }
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        // past kend p is 0: any staged V rows will do
        const int key0 = min(j0 + 16 * kk, kend - 16);
        const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        // lanes 0-15 address keys key0..key0 + 15 at columns 0, lanes 16-31
        // at columns 8 of the d-step: b0 b1 of d-tile 2 dp, then of 2 dp + 1
        const __nv_bfloat16* vp = vs + (key0 + (lane & 15)) * kLd + (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < kD; ++dp) {
          unsigned b[4];
          ldmatrix_x4_trans(b, vp + 16 * dp);
          mma_bf16(o[2 * dp], a, b);
          mma_bf16(o[2 * dp + 1], a, b + 2);
        }
      }
    }
    if (kSplit == 2) {  // the first half adds the second's PV sums and stores
      if (half == 1) {
#pragma unroll
        for (int dt = 0; dt < 2 * kD; ++dt)
#pragma unroll
          for (int x = 0; x < 4; ++x) xo[(dt * 4 + x) * 32 + lane] = o[dt][x];
      }
      pair_sync(group);
      if (half == 1) continue;
#pragma unroll
      for (int dt = 0; dt < 2 * kD; ++dt)
#pragma unroll
        for (int x = 0; x < 4; ++x) o[dt][x] += xo[(dt * 4 + x) * 32 + lane];
    }
    if (kSaveProbs && causal) {  // keys no row of the tile visits
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        if (i < seq) {
          for (int j = kvw + tig; j < seq; j += 4) prow[(size_t)i * seq + j] = 0.f;
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < 2 * kD; ++dt) {
      const int col = 8 * dt + 2 * tig;
      if (col >= head_dim) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        if (i < seq) {
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + i) * width + h * head_dim + col) =
              __floats2bfloat162_rn(o[dt][2 * r], o[dt][2 * r + 1]);
        }
      }
    }
  }
}

template <int kD, int kNT, bool kResident, bool kSaveProbs, int kSplit>
int launch_attention_mma_as(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const __nv_bfloat16* v, size_t ld, __nv_bfloat16* out,
                            float* probs, int batch, int seq, int width, int heads, int causal,
                            float scale, cudaStream_t st) {
  const int head_dim = width / heads;
  const int tiles = mma_tiles_per_block(seq, batch * heads);
  const size_t smem = mma_smem_bytes(seq, head_dim);
  const cudaError_t e =
      cudaFuncSetAttribute(attention_tiled_mma_kernel<kD, kNT, kResident, kSaveProbs, kSplit>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  const int wide = bases % 16 == 0 && ld % 8 == 0 && head_dim % 8 == 0;
  IRT_TRY(attention_tiled_mma_kernel<kD, kNT, kResident, kSaveProbs, kSplit>
          <<<dim3(heads, batch, ((seq + 15) / 16 + tiles - 1) / tiles), kMmaThreads * kSplit,
             smem, st>>>(q, k, v, ld, out, probs, seq, width, head_dim, tiles, causal, scale,
                         wide));
  return 0;
}

// The bf16 attention: the form mma_route picks, at head_dim padded to 16 kD.
template <bool kSaveProbs>
int launch_attention_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, size_t ld, __nv_bfloat16* out, float* probs,
                         int batch, int seq, int width, int heads, int causal, float scale,
                         cudaStream_t st) {
  const int head_dim = width / heads;
  if (mma_smem_bytes(seq, head_dim) > IRT_MAX_SMEM || batch > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 8 != 0) {
    return IRT_BAD_ARGS;
  }
#define IRT_MMA(KD, NT, RES, SPLIT)                                                      \
  return launch_attention_mma_as<KD, NT, RES, kSaveProbs, SPLIT>(                         \
      q, k, v, ld, out, probs, batch, seq, width, heads, causal, scale, st)
  const int kd = mma_kd(head_dim), route = mma_route(seq, head_dim);
  if (route == kRouteResidentWide) {  // head_dim <= 64
    if (kd == 1) IRT_MMA(1, kMmaHalf, true, 2);
    if (kd == 2) IRT_MMA(2, kMmaHalf, true, 2);
    IRT_MMA(4, kMmaHalf, true, 2);
  }
  if (route == kRouteResident && round16(seq) <= 64) {
    if (kd == 1) IRT_MMA(1, 8, true, 1);
    if (kd == 2) IRT_MMA(2, 8, true, 1);
    if (kd == 4) IRT_MMA(4, 8, true, 1);
    IRT_MMA(8, 8, true, 1);
  }
  if (route == kRouteResident) {
    if (kd == 1) IRT_MMA(1, kMmaChunk, true, 1);
    if (kd == 2) IRT_MMA(2, kMmaChunk, true, 1);
    if (kd == 4) IRT_MMA(4, kMmaChunk, true, 1);
    IRT_MMA(8, kMmaChunk, true, 1);
  }
  if (kd == 1) IRT_MMA(1, kMmaChunk, false, 1);
  if (kd == 2) IRT_MMA(2, kMmaChunk, false, 1);
  if (kd == 4) IRT_MMA(4, kMmaChunk, false, 1);
  IRT_MMA(8, kMmaChunk, false, 1);
#undef IRT_MMA
}

}  // namespace
