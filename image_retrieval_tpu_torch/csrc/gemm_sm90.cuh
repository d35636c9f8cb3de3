// The Hopper (sm_90a) GEMMs of every transformer-layer chain, C =
// epilogue(A Bt^T) with A (M, K) row-major and Bt (N, K) output-major (the
// weights as the chains keep them). Both operands are K-major, the only
// layout 8-bit wgmma takes, so no weight is repacked. dense_common.cuh and
// int8_common.cuh hand them their epilogues; gemm_sm90.cu exposes them alone
// for tests and timing.
//
// What bounds them on this card. 2 M N K operations against (M + N) K bytes
// of operands and M N outputs: at the chains' shapes (K >= 512, M in the
// thousands) far above the 295 operations a byte (590 in int8) where the
// tensor cores, and not device memory, set the pace. Only wgmma reaches the
// tensor cores' full rate.
//
// The GEMM (gemm_persistent_kernel; one body for bf16 operands, the
// compute-type chains K8, K9a, K9b, K11, and int8 ones, K1, K2a, K2b and
// QuantDense):
//   - Persistent and warp-specialised. The grid is the blocks the card holds
//     at once (one an SM, 132 on an H100), at most one per tile; the blocks
//     walk the tiles in a static order, a row band's column tiles together,
//     so that a band of A is read once from device memory and then from L2.
//     In each block one producer thread keeps TMA loads in flight through a
//     ring of stages across tile boundaries (running stage counters give the
//     mbarrier parities), so the next tile's stages fill during this tile's
//     epilogue. The producer is one warp: setmaxnreg (moving a producer
//     warpgroup's registers to the consumers) draws on the block's own
//     launch allocation, blocked forever when that was short, and made ptxas
//     wait on the products before touching the accumulators (C7517).
//   - Tiles of 128 columns and 64 G rows, G consumer warpgroups of 64 rows
//     (G = 1-3, gemm_tile_plan). A K step is 128 bytes of a row (64 bf16 or
//     128 int8 values), so every shared row is one 128-byte swizzle row
//     whatever the operand type. 256-row tiles (four warpgroups) take 17
//     warps, five of them on one SM sub-partition, which caps a thread at 96
//     registers: their epilogues spilled and ran slower than 192-row tiles.
//   - Every consumer warpgroup runs one wgmma shape on its 64 rows (bf16
//     m64n128k16 with f32 sums, int8 m64n128k32 with s32 sums), one
//     accumulator per output over ascending K steps, whatever the plan, with
//     no split-K and no atomics, so a row's bits depend neither on M nor on
//     the plan (int8 sums are exact; rows past M and K tails are zero-filled
//     by TMA and add nothing).
//   - The epilogue's inputs arrive under the tile's products: the tile's
//     column parameters (the bias, and in int8 the column scales) copied to
//     shared memory by cp.async, a thread's two row scales (int8) loaded into
//     registers, and the residual tile loaded by TMA into the warpgroup's
//     output slab. The epilogue finishes its values in registers by the
//     chain's functor, bf16 outputs into that 64 x 128 slab (the 128-byte
//     swizzle of two TMA boxes, each value in place of its residual), and
//     one thread stores the slab by TMA (cp.async.bulk.tensor, global from
//     shared): the store runs under the next tile's products, and the
//     warpgroup waits for it to have read the slab only before the next
//     tile's residual or outputs land there. f32 outputs (the f32 compute
//     type, and fc1 on the int8 MLP's two-launch route) are stored from
//     registers as 8-byte pairs, their residual read likewise. Rows past M
//     and columns past N are not stored.
//   - The plan chooses G for the fewest waves of tiles times the L2 bytes of
//     a tile's K step (gemm_tile_plan): 192 rows at the large batches, 128
//     or 64 where the last wave would leave most blocks idle or the batch is
//     small.
//   - Each block loads its own A tile. The kernel also runs in clusters of
//     two blocks on neighbouring column tiles, each loading half the A tile
//     and multicasting it to both (cp.async.bulk.tensor ... multicast::
//     cluster; each block's `full` barrier expects the partner's half, and a
//     stage goes back through `empty` barriers that count every consumer
//     warp of both blocks, by remote arrives through mapa): 112 flop (bf16)
//     or 224 int8 operations (256-row tiles: 256) per L2 byte against 79 and
//     154 without. On an H100 clusters of one ran 1-5 % faster at the large
//     batches and 10-15 % at the small ones (csrc/experiments/), so the
//     library takes them: once persistent, the L2 no longer holds the
//     products back.
//   - The host side of a launch is about 3-5 microseconds on an H100's host,
//     of which encoding the tensor maps and setting the shared-memory limit
//     take under half a microsecond.
//   The design's variants, each bit for bit equal to it, are timed by
//   csrc/experiments/gemm_bf16_variants.cu and gemm_s8_variants.cu (the
//   latter also beside the one-tile int8 kernel this replaced).
//
// gemm_wgmma_s8_rowquant_kernel is the int8 GEMM with a per-row
// requantization in its epilogue (the int8 MLP's fc1 -> quick_gelu ->
// rowquant): blocks of 64 rows x 512 columns, four warpgroups on one A
// tile, in a thread block cluster that covers a whole row tile, so that the
// f32 hidden rows never reach device memory (rowquant_gemm_plan; its design
// is set out beside it). It keeps a block a tile (gemm_wgmma_mainloop):
// persistent clusters ran it slower
// (csrc/experiments/rowquant_gemm_variants.cu).
//
// Both: TMA descriptors are encoded on the host (cuTensorMapEncodeTiled,
// reached through the runtime's entry-point query: the library does not
// link libcuda) and passed as __grid_constant__ parameters. An mbarrier wait
// that has not completed after ~2^34 cycles traps: a wrong phase parity
// fails the launch instead of hanging the card.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "block_common.cuh"

namespace {

constexpr int kGemmTileN = 128;     // output columns of a tile
constexpr int kGemmRowBytes = 128;  // bytes of one K step of one row
constexpr int kGemmWarpGroupRows = 64;  // rows of one consumer warpgroup
constexpr int kGemmMaxGroups = 3;       // 64-row warpgroups of the tallest tile (192 rows)
// dynamic shared memory is rounded up here to the 1024-byte alignment of
// the 128-byte swizzle
constexpr int kGemmSmemAlign = 1024;

// False for a shape no GEMM here takes: M < 1, N or K not a multiple of 64.
inline bool gemm_shape_ok(int m, int n, int k) {
  return m >= 1 && n >= 64 && k >= 64 && n % 64 == 0 && k % 64 == 0;
}

// ---------------------------------------------------------------------------
// mbarrier, TMA and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Until the phase of parity `parity` has completed; traps after ~2^34
// cycles (seconds), so that a wrong parity fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One 2-D TMA box (inner coordinate c0 in elements, row c1) into shared
// memory at `dst`, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand under the 128-byte
// swizzle: start address >> 4, leading byte offset 16 (unused by this
// layout), stride byte offset 1024 (from one 8-row group of 128-byte rows to
// the next), layout 1 (SWIZZLE_128B) in bits 62-63. The tile starts on a
// 1024-byte boundary; a K slice inside the 128-byte row is the start
// address plus its byte offset.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define IRT_WGMMA_D64(c)                                                                     \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]),  \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),        \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),        \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]),        \
      c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]),        \
      c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),        \
      c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]), c(d[57]),        \
      c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define IRT_WGMMA_REGS                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define IRT_F32_REG(x) "+f"(x)
#define IRT_S32_REG(x) "+r"(x)

// d (64 x 128 per warpgroup, f32) += A (64 x 16 bf16) * B (16 x 128 bf16),
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " IRT_WGMMA_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : IRT_WGMMA_D64(IRT_F32_REG)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128 per warpgroup, s32) += A (64 x 32 s8) * B (32 x 128 s8).
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " IRT_WGMMA_REGS ", %64, %65, p;\n}\n"
      : IRT_WGMMA_D64(IRT_S32_REG)
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// wgmma instructions that own the registers (it sees only their operands).
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The wgmma, accumulator and tensor-map type of each operand type: a K
// slice of 32 bytes is one instruction in both.
template <typename In> struct GemmOperand;
template <> struct GemmOperand<__nv_bfloat16> {
  typedef float Acc;
  static constexpr int kMmaK = 16;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    wgmma_bf16(d, da, db);
  }
};
template <> struct GemmOperand<int8_t> {
  typedef int Acc;
  static constexpr int kMmaK = 32;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db) {
    wgmma_s8(d, da, db);
  }
};

// ---------------------------------------------------------------------------
// The products of one tile a block (the clustered rowquant GEMM below)
// ---------------------------------------------------------------------------

// The block's products into d: kRowGroups x kColGroups consumer warpgroups,
// warpgroup g computing the 64 rows m0 + 64 (g / kColGroups) by the 128
// columns n0 + 128 (g % kColGroups) of the block's tile, fed by one producer
// warp through a ring of kStages stages (the A tile of 64 kRowGroups rows,
// then kColGroups B boxes of 128 rows). True in a consumer thread, whose d
// then holds its 64 sums; false in the producer warp once its loads are
// issued.
template <typename In, int kRowGroups, int kColGroups, int kStages>
__device__ __forceinline__ bool gemm_wgmma_mainloop(const CUtensorMap* map_a,
                                                    const CUtensorMap* map_b, int k_steps,
                                                    int m0, int n0,
                                                    typename GemmOperand<In>::Acc* d) {
  typedef GemmOperand<In> Op;
  constexpr int kGroups = kRowGroups * kColGroups;
  constexpr int kATile = kGemmWarpGroupRows * kRowGroups * kGemmRowBytes;
  constexpr int kBBox = kGemmTileN * kGemmRowBytes;
  constexpr int kStage = kATile + kColGroups * kBBox;
  constexpr int kSliceBytes = Op::kMmaK * (int)sizeof(In);  // 32 bytes of one K slice
  extern __shared__ uint8_t gemm_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full[s], then empty[s]

  const int tid = threadIdx.x;
  const uint32_t ring =
      (smem_u32(gemm_smem) + kGemmSmemAlign - 1) & ~(uint32_t)(kGemmSmemAlign - 1);
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[kStages]);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's expect-tx arrival
      mbar_init(empty0 + 8 * s, 128 * kGroups);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int group = tid / 128;

  if (group == kGroups) {  // the producer warp: one thread issues every load
    if (tid % 32 == 0) {
      for (int kt = 0; kt < k_steps; ++kt) {
        const int s = kt % kStages;
        // the stage's previous use (kt - kStages) released; parity 1
        // passes at once on the first round
        mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s, a = ring + s * kStage;
        mbar_arrive_expect_tx(full, kStage);
        const int k0 = kt * (kGemmRowBytes / (int)sizeof(In));
        tma_load_2d(a, map_a, full, k0, m0);
#pragma unroll
        for (int c = 0; c < kColGroups; ++c) {
          tma_load_2d(a + kATile + c * kBBox, map_b, full, k0, n0 + c * kGemmTileN);
        }
      }
    }
    return false;
  }

#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  fence_acc(d);
  const uint32_t a_rows = (group / kColGroups) * kGemmWarpGroupRows * kGemmRowBytes;
  const uint32_t b_rows = kATile + (group % kColGroups) * kBBox;
  for (int kt = 0; kt < k_steps; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
    const uint32_t a = ring + s * kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmRowBytes / kSliceBytes; ++kk) {
      Op::mma(d, wgmma_desc(a + a_rows + kk * kSliceBytes),
              wgmma_desc(a + b_rows + kk * kSliceBytes));
    }
    wgmma_commit();
    if (kt > 0) {  // the previous stage's products are done: hand it back
      wgmma_wait<1>();
      mbar_arrive(empty0 + 8 * ((kt - 1) % kStages));
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  return true;
}

// ---------------------------------------------------------------------------
// The int8 GEMM with a per-row requantization in its epilogue
// ---------------------------------------------------------------------------
//
// q, qs = rowquant(fin(A Bt^T)): every output finished to f32 by `fin`, then
// each row quantized to int8 by its absmax, s = max(absmax, 1e-12) / 127 and
// q = round_half_even(v / s), as ln_rowquant_kernel does. Only q (int8) and
// s (f32, one a row) reach device memory. The absmax spans the whole row,
// wider than a block, so the blocks that share a row tile form a thread
// block cluster: a block computes 64 rows x 512 columns with four consumer
// warpgroups of 128 columns on one A tile, and the cluster's N / 512 blocks
// (at most 8, the portable cluster size) cover all N columns. In the
// epilogue each thread finishes its two rows' 32 values in registers (the
// columns' scales and biases staged in shared memory before the products)
// and takes their |max|; the quad that shares a row reduces it by shuffles,
// the warpgroups through shared memory, and each block pushes its 64 row
// maxima into every block of the cluster (distributed shared memory)
// before one cluster barrier, after which each block reads them locally.
// The int8 rows go out through the idle ring as 16-byte stores. A max does
// not depend on the order of its inputs, so q and s equal the two launches
// this replaces (the GEMM writing f32, then ln_rowquant_kernel) bit for bit.
// One block an SM (a ring of three 72 KB stages); the sums keep the order
// that depends only on K.

constexpr int kRqColGroups = 4;                       // warpgroups of 128 columns a block
constexpr int kRqCols = kRqColGroups * kGemmTileN;    // 512 columns a block
constexpr int kRqRows = kGemmWarpGroupRows;           // 64 rows a block
constexpr int kRqStages = 3;
constexpr int kRqMaxCluster = 8;                      // portable cluster size
constexpr int kRqThreads = 128 * kRqColGroups + 32;
constexpr int kRqStagedRow = kRqCols + 16;            // bytes of a staged int8 row

// The launch plan of the fused stage (mirrored by
// ops/flash_attention.py::rowquant_gemm_plan). fused = 0 names the other
// route, the GEMM writing f32 and then a rowquant launch, taken where no
// cluster covers a row: N not a multiple of 512, more than 8 blocks, or more
// row tiles than gridDim.y holds.
struct RowquantGemmPlan {
  int fused;    // 1: one clustered launch; 0: two launches
  int cluster;  // blocks of a cluster, N / 512
  int rows;     // rows of a block (64)
  int cols;     // columns of a block (512)
  int stages;   // shared-memory ring depth
  int smem;     // dynamic shared memory of a block, bytes
  int grid_x;   // = cluster
  int grid_y;   // row tiles
  int threads;  // four consumer warpgroups and one producer warp
};

// False for a shape the int8 GEMM refuses (gemm_tile_plan: at such M its
// plan takes its tallest tiles, of which 65535 at most).
inline bool rowquant_gemm_plan(int m, int n, int k, RowquantGemmPlan* p) {
  if (!gemm_shape_ok(m, n, k) || (long long)m > 65535LL * kGemmWarpGroupRows * kGemmMaxGroups) {
    return false;
  }
  *p = RowquantGemmPlan{};
  const long long row_tiles = ((long long)m + kRqRows - 1) / kRqRows;
  if (n % kRqCols || n / kRqCols > kRqMaxCluster || row_tiles > 65535) return true;
  p->fused = 1;
  p->cluster = n / kRqCols;
  p->rows = kRqRows;
  p->cols = kRqCols;
  p->stages = kRqStages;
  p->smem = kRqStages * (kRqRows + kRqCols) * kGemmRowBytes + kGemmSmemAlign;
  p->grid_x = p->cluster;
  p->grid_y = (int)row_tiles;
  p->threads = kRqThreads;
  return true;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// Every thread of every block of the cluster arrives; the wait returns once
// all have. The arrive releases and the wait acquires (their default
// semantics): shared-memory writes before the arrive, to this block's
// shared memory or a peer's, are seen by reads after the wait. The relaxed
// arrive orders nothing: its wait only says that every block has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// Stores v at this block's shared address `p` in block `rank` of the cluster.
__device__ __forceinline__ void st_cluster_f32(float* p, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}
// The consumer warpgroups alone (the producer warp does not take part).
__device__ __forceinline__ void rowquant_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kRqColGroups) : "memory");
}

// Fin: fields row_scale, col_scale, bias, m and n, and finish(acc,
// row_scale[row], col_scale[col], bias[col]) -> f32 (Int8Epilogue<float,
// kGelu> of int8_common.cuh). q (m, n) int8, qs (m,).
template <typename Fin>
__global__ void __launch_bounds__(kRqThreads, 1)
    gemm_wgmma_s8_rowquant_kernel(const __grid_constant__ CUtensorMap map_a,
                                  const __grid_constant__ CUtensorMap map_b, int k_steps,
                                  Fin fin, int8_t* __restrict__ q, float* __restrict__ qs) {
  __shared__ __align__(16) float col_scale[kRqCols];
  __shared__ __align__(16) float col_bias[kRqCols];
  __shared__ float group_max[kRqColGroups][kRqRows];
  __shared__ float row_max[kRqMaxCluster][kRqRows];  // [block of the cluster][row]
  extern __shared__ uint8_t gemm_smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kRqRows, n0 = blockIdx.x * kRqCols;
  cluster_arrive_relaxed();  // its wait, before the first push, says all blocks started
  if (tid < kRqCols / 4) {   // visible once the products' first barrier has passed
    reinterpret_cast<float4*>(col_scale)[tid] =
        reinterpret_cast<const float4*>(fin.col_scale + n0)[tid];
    reinterpret_cast<float4*>(col_bias)[tid] = reinterpret_cast<const float4*>(fin.bias + n0)[tid];
  }
  int d[64];
  const bool consumer =
      gemm_wgmma_mainloop<int8_t, 1, kRqColGroups, kRqStages>(&map_a, &map_b, k_steps, m0, n0, d);
  const int group = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int lr = 16 * w + lane / 4;  // the thread's rows: lr and lr + 8 of the block
  const int lc = group * kGemmTileN + 2 * (lane % 4);  // its first column in the block
  const uint32_t rank = cluster_rank(), blocks = cluster_blocks();
  float amax[2] = {0.f, 0.f};
  if (consumer) {
    float rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + lr + 8 * h;
      rs[h] = r < fin.m ? fin.row_scale[r] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kGemmTileN / 8; ++i) {
      // the pair of columns this thread holds in slice i, for both its rows
      const float2 cs = *reinterpret_cast<const float2*>(&col_scale[lc + 8 * i]);
      const float2 cb = *reinterpret_cast<const float2*>(&col_bias[lc + 8 * i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = fin.finish(d[4 * i + 2 * h], rs[h], cs.x, cb.x);
        const float v1 = fin.finish(d[4 * i + 2 * h + 1], rs[h], cs.y, cb.y);
        d[4 * i + 2 * h] = __float_as_int(v0);
        d[4 * i + 2 * h + 1] = __float_as_int(v1);
        amax[h] = fmaxf(amax[h], fmaxf(fabsf(v0), fabsf(v1)));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four lanes of a quad hold one row
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
      if (lane % 4 == 0) group_max[group][lr + 8 * h] = amax[h];
    }
    rowquant_consumers_sync();  // also: every warpgroup's products are done, the ring idle
  }
  __syncwarp();
  cluster_wait();  // every block of the cluster has started: its shared memory is there
  if (consumer && group == 0 && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = group_max[0][lr + 8 * h];
#pragma unroll
      for (int g = 1; g < kRqColGroups; ++g) a = fmaxf(a, group_max[g][lr + 8 * h]);
      for (uint32_t b = 0; b < blocks; ++b) st_cluster_f32(&row_max[rank][lr + 8 * h], b, a);
    }
  }
  __syncwarp();
  cluster_arrive();  // this block's maxima pushed to every block
  cluster_wait();    // every block's maxima here; no peer writes here any more
  if (!consumer) return;
  uint8_t* staged =
      gemm_smem + ((smem_u32(gemm_smem) + kGemmSmemAlign - 1) & ~(uint32_t)(kGemmSmemAlign - 1)) -
      smem_u32(gemm_smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float a = row_max[0][lr + 8 * h];
    for (uint32_t b = 1; b < blocks; ++b) a = fmaxf(a, row_max[b][lr + 8 * h]);
    const float s = __fdiv_rn(fmaxf(a, 1e-12f), 127.f);
#pragma unroll
    for (int i = 0; i < kGemmTileN / 8; ++i) {
      char2 pair;
      pair.x = (signed char)__float2int_rn(__fdiv_rn(__int_as_float(d[4 * i + 2 * h]), s));
      pair.y = (signed char)__float2int_rn(__fdiv_rn(__int_as_float(d[4 * i + 2 * h + 1]), s));
      *reinterpret_cast<char2*>(staged + (lr + 8 * h) * kRqStagedRow + lc + 8 * i) = pair;
    }
    const int r = m0 + lr + 8 * h;
    if (rank == 0 && group == 0 && lane % 4 == 0 && r < fin.m) qs[r] = s;
  }
  rowquant_consumers_sync();
  // the block's int8 tile, 16 bytes a thread, whole rows of 512 bytes a warp
#pragma unroll
  for (int c = tid; c < kRqRows * (kRqCols / 16); c += 128 * kRqColGroups) {
    const int row = c / (kRqCols / 16), col = 16 * (c % (kRqCols / 16));
    if (m0 + row < fin.m) {
      *reinterpret_cast<uint4*>(q + (size_t)(m0 + row) * fin.n + n0 + col) =
          *reinterpret_cast<const uint4*>(staged + row * kRqStagedRow + col);
    }
  }
}

// ---------------------------------------------------------------------------
// The persistent GEMM: clusters over tiles, a multicast A tile, TMA stores
// ---------------------------------------------------------------------------

constexpr int kGemmGroupOut = kGemmWarpGroupRows * kGemmTileN * 2;  // a warpgroup's bf16 slab
constexpr int kGemmSmemLimit = 232448;  // shared memory a block may take (227 KB)
constexpr int kGemmStaticReserve = 256;  // the kernel's static barriers, at most

// A block of tiles of 64 kG rows: kG consumer warpgroups of 64 rows and one
// producer warp. Each warpgroup stages its outputs through one 64 x 128
// bf16 slab and its tile's kParams column parameters (128 f32 each); the
// ring takes as many stages of (64 kG + 128) rows of 128 bytes as fit beside
// them, at most 8. One block an SM.
constexpr int gemm_fixed_smem(int g, int params) {
  return g * (kGemmGroupOut + params * kGemmTileN * 4) + kGemmSmemAlign;
}
constexpr int gemm_stage_bytes(int g) {
  return (kGemmWarpGroupRows * g + kGemmTileN) * kGemmRowBytes;
}
constexpr int gemm_stages(int g, int params) {
  return (kGemmSmemLimit - kGemmStaticReserve - gemm_fixed_smem(g, params)) /
                     gemm_stage_bytes(g) > 8
             ? 8
             : (kGemmSmemLimit - kGemmStaticReserve - gemm_fixed_smem(g, params)) /
                   gemm_stage_bytes(g);
}
template <int kG, int kParams> struct GemmBlock {
  static constexpr int kRows = kGemmWarpGroupRows * kG;
  static constexpr int kATile = kRows * kGemmRowBytes;
  static constexpr int kBTile = kGemmTileN * kGemmRowBytes;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kStages = gemm_stages(kG, kParams);
  static constexpr int kOut = kG * kGemmGroupOut;  // the output slabs, after the ring
  static constexpr int kSmem = kStages * kStage + gemm_fixed_smem(kG, kParams);
  static constexpr int kThreads = 128 * kG + 32;
};

// The launch plan of one GEMM (mirrored by ops/flash_attention.py::gemm_plan).
struct GemmTilePlan {
  int rows;       // output rows of a tile: 64 G
  int stages;     // shared-memory ring depth
  int smem;       // dynamic shared memory of a block, bytes
  int blocks;     // blocks launched
  int threads;    // 128 per consumer warpgroup and a producer warp
  int col_tiles;  // column tiles of 128
  int row_tiles;  // row bands of `rows`
  int waves;      // tiles per launched block, rounded up
};

// Tiles of 64 G rows for the G in 1-3 that minimises waves x (G + 2): a K
// step of a block moves (G + 2) x 8 KB from L2 (its A tile and its B tile),
// the GEMM runs at the rate the L2 delivers those, so a tile costs G + 2,
// and a wave of the `slots` blocks the card holds at once costs one tile.
// Ties go to the taller tile. The launch takes min(slots, tiles) blocks.
// params: the column parameters a tile stages (bf16 1, the bias; int8 2, the
// column scales too). False for a shape the kernel does not take: M < 1, N
// or K not a multiple of 64, or more than 65535 row tiles (the chains'
// bound, rows_ok).
inline bool gemm_tile_plan(int m, int n, int k, int slots, int params, GemmTilePlan* p) {
  if (!gemm_shape_ok(m, n, k) || slots < 1) return false;
  const long long cols = (n + kGemmTileN - 1) / kGemmTileN;
  int best = 0;
  long long best_cost = 0;
  for (int g = kGemmMaxGroups; g >= 1; --g) {
    const long long bands = ((long long)m + 64 * g - 1) / (64 * g);
    const long long cost = (bands * cols + slots - 1) / slots * (g + 2);
    if (best == 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  const long long bands = ((long long)m + 64 * best - 1) / (64 * best);
  if (bands > 65535) return false;
  const long long tiles = bands * cols;
  p->rows = kGemmWarpGroupRows * best;
  p->stages = gemm_stages(best, params);
  p->smem = p->stages * gemm_stage_bytes(best) + gemm_fixed_smem(best, params);
  p->threads = 128 * best + 32;
  p->blocks = (int)(tiles < slots ? tiles : slots);
  p->col_tiles = (int)cols;
  p->row_tiles = (int)bands;
  p->waves = (int)((tiles + slots - 1) / slots);
  return true;
}

// One 2-D TMA box into the shared memory of every block of the cluster in
// `mask`, at the same offset, completing each one's `bar` (the same offset
// too) by the box's bytes.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}
// One 2-D TMA box from shared memory at `src` to the tensor at (c0, c1);
// elements past the tensor's edges are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's committed stores have read their shared memory ...
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... or have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// This thread's shared-memory writes, made visible to TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// An arrival on the mbarrier at this block's shared address `bar`, in block
// `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t at) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(at) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_b32(uint32_t at, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
}

// C (m, n) = epi(A Bt^T) for In (bf16 or int8) operands, persistent over
// `tiles` cluster tiles (row band, kCluster neighbouring column tiles;
// `pairs` a band), cluster c taking c, c + clusters, ... With kCluster 2
// the A tile is multicast to both blocks; with 1 each block loads its own.
// Epi (DenseEpilogueBf16 of dense_common.cuh, Int8Epilogue of
// int8_common.cuh): the output type Out, kColParams column parameters
// (col_param(j), staged a tile in shared memory), kRowScale
// (row_scale[row], two a thread in registers), kAddsResidual (a residual
// (m, n) of Out: by TMA into the slab for bf16, read from `residual` for
// f32), fields m and n, and operator()(acc, row scale, param 0, param 1,
// residual) -> the finished f32 value before its cast to Out. bf16 outputs:
// map_c and map_r are C and the residual as boxes of 64 rows x 64 columns
// under the 128-byte swizzle; f32 outputs: stored at c from registers.
template <typename In, int kG, int kCluster, typename Epi>
__global__ void __launch_bounds__(GemmBlock<kG, Epi::kColParams>::kThreads, 1)
    gemm_persistent_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_c,
                           const __grid_constant__ CUtensorMap map_r,
                           typename Epi::Out* __restrict__ c,
                           const typename Epi::Out* __restrict__ residual, int k_steps,
                           int pairs, int tiles, Epi epi) {
  typedef GemmBlock<kG, Epi::kColParams> B;
  typedef GemmOperand<In> Op;
  typedef typename Epi::Out Out;
  constexpr bool kSlab = sizeof(Out) == 2;  // bf16 outputs leave by TMA
  constexpr int kS = B::kStages;
  constexpr int kP = Epi::kColParams;
  constexpr int kAPart = B::kATile / kCluster;  // bytes of the A rows this block loads
  constexpr int kSliceBytes = Op::kMmaK * (int)sizeof(In);  // 32: one wgmma's K slice
  constexpr int kBoxBytes = kGemmWarpGroupRows * 128;  // a 64 x 64 bf16 box of a C slab
  extern __shared__ uint8_t gemm_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kS + kG];  // full[s], empty[s], residual[g]

  const int tid = threadIdx.x, group = tid / 128;  // group kG: the producer warp
  const uint32_t base = smem_u32(gemm_smem);
  const uint32_t ring = (base + kGemmSmemAlign - 1) & ~(uint32_t)(kGemmSmemAlign - 1);
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[kS]);
  const uint32_t res0 = smem_u32(&bars[2 * kS]);
  // the cluster spans kCluster consecutive blocks of the 1-D grid
  const uint32_t rank = blockIdx.x % kCluster;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);                    // the producer's expect-tx
      mbar_init(empty0 + 8 * s, kCluster * kG * 4);   // each consumer warp of the cluster
    }
    for (int g = 0; g < kG; ++g) mbar_init(res0 + 8 * g, 1);  // a warpgroup's residual load
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers are initialised before a peer multicasts or arrives
  if (kCluster > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  if (group == kG) {
    if (tid == 128 * kG) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = cluster; t < tiles; t += clusters) {
        const int band = t / pairs;
        const int a_row = band * B::kRows + (int)rank * (B::kRows / kCluster);
        const int n0 = (kCluster * (t - band * pairs) + (int)rank) * kGemmTileN;
        for (int kt = 0; kt < k_steps; ++kt) {
          // the consumers of both blocks have released the stage's last
          // use; parity 1 passes at once on the first round
          mbar_wait(empty0 + 8 * s, phase ^ 1);
          const uint32_t full = full0 + 8 * s, stage = ring + s * B::kStage;
          mbar_arrive_expect_tx(full, B::kStage);  // the partner's half of A included
          const int k0 = kt * (kGemmRowBytes / (int)sizeof(In));
          if (kCluster > 1) {
            tma_load_2d_multicast(stage + rank * kAPart, &map_a, full, k0, a_row,
                                  (uint16_t)((1 << kCluster) - 1));
          } else {
            tma_load_2d(stage, &map_a, full, k0, a_row);
          }
          tma_load_2d(stage + B::kATile, &map_b, full, k0, n0);
          if (++s == kS) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    const int g = group, wt = tid % 128, w = wt / 32, lane = tid % 32;
    const uint32_t a_rows = g * kGemmWarpGroupRows * kGemmRowBytes;
    // this warpgroup's C slab of 64 rows x 128 columns, then its column
    // parameters [kP][128]
    const uint32_t out = ring + kS * B::kStage + g * kGemmGroupOut;
    float* cols = reinterpret_cast<float*>(gemm_smem + (ring - base) + kS * B::kStage +
                                           B::kOut) +
                  g * kP * kGemmTileN;
    const int lr = 16 * w + lane / 4;  // rows lr and lr + 8 of the slab; lr % 8 = lane / 4
    typename Op::Acc d[64];
    int s = 0, prev = 0;
    uint32_t phase = 0, res_phase = 0;
    for (int t = cluster; t < tiles; t += clusters) {
      const int band = t / pairs;
      const int m0 = band * B::kRows + g * kGemmWarpGroupRows;  // its first row
      const int n0 = (kCluster * (t - band * pairs) + (int)rank) * kGemmTileN;
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0;
      fence_acc(d);
      for (int kt = 0; kt <= k_steps; ++kt) {
        if (kt < k_steps) {
          mbar_wait(full0 + 8 * s, phase);
          const uint32_t stage = ring + s * B::kStage;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kGemmRowBytes / kSliceBytes; ++kk) {
            Op::mma(d, wgmma_desc(stage + a_rows + kk * kSliceBytes),
                    wgmma_desc(stage + B::kATile + kk * kSliceBytes));
          }
          wgmma_commit();
        }
        // The epilogue's inputs, fetched under the products: the slab and
        // the parameters are free, since the last epilogue's threads all
        // passed its closing barrier, and its stores have read the slab
        // once the waiting thread returns (after one K step's products, so
        // that the wait overlaps them). No thread waits for a copy before
        // the epilogue.
        if (kt == (k_steps > 1 ? 1 : 0)) {
          if constexpr (Epi::kAddsResidual && kSlab) {
            if (wt == 0) {
              bulk_wait_read();
              mbar_arrive_expect_tx(res0 + 8 * g, kGemmGroupOut);
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                tma_load_2d(out + b * kBoxBytes, &map_r, res0 + 8 * g, n0 + 64 * b, m0);
              }
            }
          }
        }
        if (kt == 0) {
          if (wt < 32 * kP) {  // 16 bytes a thread, zeros past N
            const int j = wt / 32, c4 = 4 * (wt % 32);
            const bool in = n0 + c4 < epi.n;
            cp_async16(&cols[j * kGemmTileN + c4], epi.col_param(j) + (in ? n0 + c4 : 0),
                       in ? 16 : 0);
          }
          cp_async_commit();
          if constexpr (Epi::kRowScale) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m0 + lr + 8 * h;
              rs[h] = r < epi.m ? epi.row_scale[r] : 0.f;
            }
          }
        }
        if (kt > 0) {
          // the previous stage's products are done: each warp hands it back
          // to the producers of both blocks
          if (kt < k_steps) {
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          if (lane == 0) {
#pragma unroll
            for (int r = 0; r < kCluster; ++r) {
              if (kCluster > 1) {
                mbar_arrive_cluster(empty0 + 8 * prev, r);
              } else {
                mbar_arrive(empty0 + 8 * prev);
              }
            }
          }
        }
        if (kt < k_steps) {
          prev = s;
          if (++s == kS) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      fence_acc(d);

      if constexpr (kSlab) {
        // Finished bf16 pairs into the slab (two boxes of 64 rows x 128
        // bytes; 16-byte chunk c of row r sits at chunk c ^ (r % 8)), each in
        // place of its residual, then one TMA store a box, which runs on
        // under the next tile's products.
        if constexpr (Epi::kAddsResidual) {
          mbar_wait(res0 + 8 * g, res_phase);
          res_phase ^= 1;
        } else if (wt == 0) {
          bulk_wait_read();  // the slab's last stores have read it
        }
        cp_async_wait<0>();
        named_bar_sync(1 + g, 128);  // the slab free, the parameters staged
        if (m0 < epi.m) {
#pragma unroll
          for (int i = 0; i < kGemmTileN / 8; ++i) {
            if (n0 + 64 * (i / 8) >= epi.n) continue;  // a box past N: not stored
            const int cl = 8 * i + 2 * (lane % 4);
            const float2 p0 = *reinterpret_cast<const float2*>(&cols[cl]);
            const float2 p1 = kP > 1 ? *reinterpret_cast<const float2*>(&cols[kGemmTileN + cl])
                                     : make_float2(0.f, 0.f);
            const uint32_t at = out + (i / 8) * kBoxBytes + lr * 128 +
                                ((i % 8) ^ (lane / 4)) * 16 + 4 * (lane % 4);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (m0 + lr + 8 * h >= epi.m) continue;
              float r0 = 0.f, r1 = 0.f;
              if constexpr (Epi::kAddsResidual) {
                const uint32_t rb = ld_shared_b32(at + 8 * h * 128);
                r0 = __uint_as_float(rb << 16);
                r1 = __uint_as_float(rb & 0xFFFF0000u);
              }
              const __nv_bfloat16 v0 =
                  __float2bfloat16(epi(d[4 * i + 2 * h], rs[h], p0.x, p1.x, r0));
              const __nv_bfloat16 v1 =
                  __float2bfloat16(epi(d[4 * i + 2 * h + 1], rs[h], p0.y, p1.y, r1));
              st_shared_b32(at + 8 * h * 128, (uint32_t)__bfloat16_as_ushort(v0) |
                                                  ((uint32_t)__bfloat16_as_ushort(v1) << 16));
            }
          }
        }
        fence_proxy_async_shared();
        named_bar_sync(1 + g, 128);
        if (wt == 0 && m0 < epi.m) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            if (n0 + 64 * b < epi.n) tma_store_2d(&map_c, out + b * kBoxBytes, n0 + 64 * b, m0);
          }
          bulk_commit();
        }
      } else {
        // f32 outputs: 8-byte pairs from registers, as wgmma's C fragment
        // holds them (rows lr and lr + 8, columns 8 i + 2 (lane % 4) + {0, 1})
        cp_async_wait<0>();
        named_bar_sync(1 + g, 128);  // the parameters staged
#pragma unroll
        for (int i = 0; i < kGemmTileN / 8; ++i) {
          if (n0 + 8 * i >= epi.n) break;  // the partner's tile or a last one of 64
          const int cl = 8 * i + 2 * (lane % 4);
          const float2 p0 = *reinterpret_cast<const float2*>(&cols[cl]);
          const float2 p1 = kP > 1 ? *reinterpret_cast<const float2*>(&cols[kGemmTileN + cl])
                                   : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + lr + 8 * h;
            if (r >= epi.m) continue;
            const size_t o = (size_t)r * epi.n + n0 + cl;
            float2 res = make_float2(0.f, 0.f);
            if constexpr (Epi::kAddsResidual) {
              res = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(residual) + o);
            }
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(c) + o) =
                make_float2(epi(d[4 * i + 2 * h], rs[h], p0.x, p1.x, res.x),
                            epi(d[4 * i + 2 * h + 1], rs[h], p0.y, p1.y, res.y));
          }
        }
        named_bar_sync(1 + g, 128);  // every thread done with the parameters
      }
    }
    // the block's shared memory outlives its stores' reads (their writes
    // complete before the grid does)
    if (kSlab && wt == 0) bulk_wait_read();
  }
  __syncwarp();
  // no block leaves while its partner may still multicast into it or
  // release a stage to it
  if (kCluster > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime already loaded;
// null when it has none.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p
                                                                       : nullptr;
  }();
  return fn;
}

// A (rows, k) K-major matrix as boxes of (box_rows, 128 bytes), 128-byte
// swizzle, zeros past its edges.
template <typename In>
bool encode_operand(CUtensorMap* map, const In* base, int rows, int k, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(In)};
  const cuuint32_t box[2] = {(cuuint32_t)(kGemmRowBytes / sizeof(In)), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, GemmOperand<In>::kMapType, 2, (void*)base, dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch of the fused stage on the plan's cluster. IRT_BAD_ARGS for a
// shape whose plan takes the two-launch route: the caller follows the plan,
// and nothing falls back from one route to the other. A cluster the card
// cannot schedule fails the launch.
inline cudaLaunchConfig_t rowquant_launch_config(const RowquantGemmPlan& p, cudaStream_t st,
                                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid_x, p.grid_y);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Fin>
int launch_gemm_s8_rowquant(const int8_t* a, const int8_t* bt, int k, const Fin& fin,
                            int8_t* q, float* qs, cudaStream_t st) {
  RowquantGemmPlan p;
  if (!rowquant_gemm_plan(fin.m, fin.n, k, &p) || !p.fused) return IRT_BAD_ARGS;
  if ((uintptr_t)a % 16 || (uintptr_t)bt % 16) return IRT_BAD_ARGS;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap ma, mb;
  if (!encode_operand(&ma, a, fin.m, k, p.rows) ||
      !encode_operand(&mb, bt, fin.n, k, kGemmTileN)) {
    return IRT_BAD_ARGS;
  }
  const int k_steps = (k + kGemmRowBytes - 1) / kGemmRowBytes;
  void (*kernel)(const CUtensorMap, const CUtensorMap, int, Fin, int8_t*, float*) =
      gemm_wgmma_s8_rowquant_kernel<Fin>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = rowquant_launch_config(p, st, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, ma, mb, k_steps, fin, q, qs);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of the fused stage the card holds at once for this
// shape (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
template <typename Fin>
int rowquant_max_clusters(int m, int n, int k) {
  RowquantGemmPlan p;
  if (!rowquant_gemm_plan(m, n, k, &p) || !p.fused) return -IRT_BAD_ARGS;
  void (*kernel)(const CUtensorMap, const CUtensorMap, int, Fin, int8_t*, float*) =
      gemm_wgmma_s8_rowquant_kernel<Fin>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = rowquant_launch_config(p, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

template <typename In, int kG, int kCluster, typename Epi>
using GemmKernelFn = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                              const CUtensorMap, typename Epi::Out*, const typename Epi::Out*,
                              int, int, int, Epi);

// A launch of `blocks` blocks in clusters of `cluster` (1: a plain launch).
inline cudaLaunchConfig_t gemm_launch_config(int blocks, int threads, int smem, int cluster,
                                             cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// The GEMM on the block form kG in clusters of kCluster, over col_tiles x
// row_tiles tiles on `blocks` blocks; `residual` is read by the epilogues
// that add one. IRT_BAD_ARGS where TMA cannot address an operand, C or the
// residual (a base not 16-byte aligned).
template <typename In, int kG, int kCluster, typename Epi>
int launch_gemm_form(const In* a, const In* bt, const typename Epi::Out* residual,
                     typename Epi::Out* c, int k, const Epi& epi, int col_tiles, int row_tiles,
                     int blocks, cudaStream_t st) {
  typedef GemmBlock<kG, Epi::kColParams> B;
  typedef typename Epi::Out Out;
  if ((uintptr_t)a % 16 || (uintptr_t)bt % 16 || (uintptr_t)c % 16) return IRT_BAD_ARGS;
  if (Epi::kAddsResidual && (residual == nullptr || (uintptr_t)residual % 16)) {
    return IRT_BAD_ARGS;
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap ma, mb, mc = {}, mr = {};
  if (!encode_operand(&ma, a, epi.m, k, B::kRows / kCluster) ||
      !encode_operand(&mb, bt, epi.n, k, kGemmTileN)) {
    return IRT_BAD_ARGS;
  }
  if constexpr (sizeof(Out) == 2) {  // bf16 outputs and residuals pass through the slab
    if (!encode_operand(&mc, (const Out*)c, epi.m, epi.n, kGemmWarpGroupRows) ||
        (Epi::kAddsResidual &&
         !encode_operand(&mr, residual, epi.m, epi.n, kGemmWarpGroupRows))) {
      return IRT_BAD_ARGS;
    }
  }
  const GemmKernelFn<In, kG, kCluster, Epi> kernel = gemm_persistent_kernel<In, kG, kCluster, Epi>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int pairs = (col_tiles + kCluster - 1) / kCluster;
  const int k_steps = (k * (int)sizeof(In) + kGemmRowBytes - 1) / kGemmRowBytes;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gemm_launch_config(blocks, B::kThreads, B::kSmem, kCluster, st,
                                                    &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, ma, mb, mc, mr, c, residual, k_steps, pairs,
                         row_tiles * pairs, epi);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The library's block form of the plan's tile height: a block loads its own
// A tile (clusters of one).
template <typename In, typename Epi>
int launch_gemm_plan(const In* a, const In* bt, const typename Epi::Out* residual,
                     typename Epi::Out* c, int k, const Epi& epi, const GemmTilePlan& p,
                     cudaStream_t st) {
#define IRT_GEMM_FORM(G) \
  launch_gemm_form<In, G, 1>(a, bt, residual, c, k, epi, p.col_tiles, p.row_tiles, p.blocks, st)
  switch (p.rows) {
    case 192:
      return IRT_GEMM_FORM(3);
    case 128:
      return IRT_GEMM_FORM(2);
    default:
      return IRT_GEMM_FORM(1);
  }
#undef IRT_GEMM_FORM
}

// How many clusters of kCluster blocks of the form kG the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
template <typename In, int kG, int kCluster, typename Epi>
int gemm_max_clusters_as() {
  typedef GemmBlock<kG, Epi::kColParams> B;
  const GemmKernelFn<In, kG, kCluster, Epi> kernel = gemm_persistent_kernel<In, kG, kCluster, Epi>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B::kSmem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      gemm_launch_config(kCluster, B::kThreads, B::kSmem, kCluster, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// How many blocks of the library's form kG the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs), or minus a
// CUDA error code.
template <typename In, int kG, typename Epi>
int gemm_max_blocks_as() {
  typedef GemmBlock<kG, Epi::kColParams> B;
  const GemmKernelFn<In, kG, 1, Epi> kernel = gemm_persistent_kernel<In, kG, 1, Epi>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B::kSmem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, B::kThreads, B::kSmem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? per_sm * sms : -(int)e;
}

// The plan's `slots`: the blocks the current card holds at once, the fewest
// over the three block forms (each takes one block an SM), asked once per
// device (a process may drive several cards, and a card of another kind
// holds another count); or minus a CUDA error code.
constexpr int kGemmMaxDevices = 64;

template <typename In, typename Epi>
int gemm_slots() {
  static std::atomic<int> known[kGemmMaxDevices];  // 0: not asked yet
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 0 || dev >= kGemmMaxDevices) return -(int)cudaErrorInvalidDevice;
  int slots = known[dev].load(std::memory_order_relaxed);
  if (slots == 0) {
    const int n[3] = {gemm_max_blocks_as<In, 1, Epi>(), gemm_max_blocks_as<In, 2, Epi>(),
                      gemm_max_blocks_as<In, 3, Epi>()};
    slots = n[0];
    for (int i = 1; i < 3; ++i) slots = n[i] < slots ? n[i] : slots;
    if (slots <= 0) return slots == 0 ? -(int)cudaErrorInvalidConfiguration : slots;
    known[dev].store(slots, std::memory_order_relaxed);
  }
  return slots;
}

// C (epi.m, epi.n) = epi(A Bt^T) for A (epi.m, k) and Bt (epi.n, k) of In
// (bf16 or int8), on the plan gemm_tile_plan gives the shape on this card.
// IRT_BAD_ARGS for a shape the plan refuses or a base TMA cannot address.
template <typename In, typename Epi>
int launch_gemm_tc(const In* a, const In* bt, const typename Epi::Out* residual,
                   typename Epi::Out* c, int k, const Epi& epi, cudaStream_t st) {
  const int slots = gemm_slots<In, Epi>();
  if (slots < 0) return -slots;
  GemmTilePlan p;
  if (!gemm_tile_plan(epi.m, epi.n, k, slots, Epi::kColParams, &p)) return IRT_BAD_ARGS;
  return launch_gemm_plan<In>(a, bt, residual, c, k, epi, p, st);
}

}  // namespace
