// The Hopper (sm_90a) GEMM of every transformer-layer chain: one kernel for
// bf16 and one for int8, both C = epilogue(A Bt^T) with A (M, K) row-major
// and Bt (N, K) output-major (the weights as the chains keep them). Both
// operands are K-major, the only layout 8-bit wgmma takes, so no weight is
// repacked. dense_common.cuh and int8_common.cuh hand it their epilogues;
// gemm_sm90.cu exposes it alone for tests and timing.
//
// What bounds it on this card. 2 M N K operations against (M + N) K bytes of
// operands and M N outputs: at the chains' shapes (K >= 512, M in the
// thousands) far above the 295 operations a byte where the tensor cores, and
// not memory, set the pace. Only wgmma reaches the tensor cores' full rate.
//
// The design.
//   - A block computes an output tile of 128 columns and 256 rows (128 or 64
//     where larger tiles would leave SMs idle, gemm_plan). At 128 x 128 both
//     GEMMs ran at the rate the L2 delivers operands to the SMs (6.2-7.9 TB/s
//     on an H100); 256-row tiles move a quarter fewer bytes a product. K
//     steps are 128 bytes: 64 bf16 or 128 int8 values, so every shared row
//     is one 128-byte swizzle row.
//   - A ring of stages (A tile + B tile) in dynamic shared memory: four of
//     48 KB at 256 rows (one block an SM); three of 32 KB at 128 rows and four
//     of 24 KB at 64 rows, 97 KB a block, so that two blocks share an SM and
//     one's pipeline fill and epilogue overlap the other's products. One
//     producer warp issues the TMA loads of a stage against its `full`
//     mbarrier (expect-tx: the box's bytes, zero-filled rows past M and K
//     tails included).
//   - One consumer warpgroup per 64 rows runs wgmma m64n128k16 (bf16, f32
//     sums) or m64n128k32 (s8, s32 sums), both operands read from shared
//     memory through descriptors, four per stage. A stage goes back to the
//     producer through its `empty` mbarrier once wgmma.wait_group says that
//     the products reading it have finished: the products of one stage
//     overlap the wait for the next.
//   - The epilogue reads the accumulators in registers: warp w of a
//     warpgroup holds rows 16 w + lane / 4 and + 8 at columns
//     8 i + 2 (lane % 4) + {0, 1} of each n8 slice i, as mma.sync's C
//     fragment. Rows past M and columns past N are not stored.
//   - No split-K and no atomics: each output's sum has one fixed order that
//     depends only on K, so launches on the same operands give the same
//     bits whatever M is.
//   - gemm_wgmma_s8_rowquant_kernel is the int8 GEMM with a per-row
//     requantization in its epilogue (the int8 MLP's fc1 -> quick_gelu ->
//     rowquant): blocks of 64 rows x 512 columns, four warpgroups on one A
//     tile, in a thread block cluster that covers a whole row tile, so that
//     the f32 hidden rows never reach device memory (rowquant_gemm_plan;
//     its design is set out beside it).
//   - TMA descriptors are encoded on the host per launch
//     (cuTensorMapEncodeTiled, reached through the runtime's entry-point
//     query: the library does not link libcuda) and passed as
//     __grid_constant__ parameters.
//   - An mbarrier wait that has not completed after ~2^34 cycles traps: a
//     wrong phase parity fails the launch instead of hanging the card.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "block_common.cuh"

namespace {

constexpr int kGemmTileN = 128;     // output columns of a block
constexpr int kGemmRowBytes = 128;  // bytes of one K step of one row
// Ring depth by consumer warpgroups (64 rows each): four stages of 48 KB at
// 256-row tiles (one block an SM), three of 32 KB at 128 rows and four of
// 24 KB at 64 rows (two blocks an SM: one's loads and epilogue overlap the
// other's products).
template <int kGroups> struct GemmStages { static constexpr int value = kGroups == 2 ? 3 : 4; };
template <int kGroups> struct GemmBlocksPerSm { static constexpr int value = kGroups == 4 ? 1 : 2; };
constexpr int kGemmWarpGroupRows = 64;  // rows of one consumer warpgroup
constexpr int kGemmSmSlots = 132;        // SMs of an H100 SXM
// dynamic shared memory is rounded up here to the 1024-byte alignment of
// the 128-byte swizzle
constexpr int kGemmSmemAlign = 1024;

// The launch plan of one GEMM (mirrored by ops/flash_attention.py::gemm_plan).
struct GemmPlan {
  int rows;     // output rows of a block: 256, 128 or 64 (a consumer warpgroup per 64)
  int stages;   // shared-memory ring depth
  int smem;     // dynamic shared memory of a block, bytes
  int grid_x;   // column tiles
  int grid_y;   // row tiles
  int threads;  // 128 per consumer warpgroup + one producer warp
};

// Tiles of 256 rows where they give every SM a block (the fewest operand
// bytes a product: both GEMMs are bound by what the L2 delivers to the SMs
// at 128 x 128), else 128 rows where those do, else 64. dtype 0 = bf16,
// 1 = int8. False for a shape the kernel does not take: M < 1, N or K not a
// multiple of 64, or more row tiles than gridDim.y holds.
inline bool gemm_plan(int m, int n, int k, int dtype, GemmPlan* p) {
  if (m < 1 || n < 64 || k < 64 || n % 64 || k % 64 || (dtype != 0 && dtype != 1)) return false;
  const long long cols = (n + kGemmTileN - 1) / kGemmTileN;
  const long long tiles128 = ((long long)m + 127) / 128 * cols;
  const long long tiles256 = ((long long)m + 255) / 256 * cols;
  p->rows = tiles256 >= kGemmSmSlots ? 256 : tiles128 < kGemmSmSlots ? 64 : 128;
  const long long row_tiles = ((long long)m + p->rows - 1) / p->rows;
  if (row_tiles > 65535) return false;
  p->stages = p->rows == 256   ? GemmStages<4>::value
              : p->rows == 128 ? GemmStages<2>::value
                               : GemmStages<1>::value;
  p->smem = p->stages * (p->rows + kGemmTileN) * kGemmRowBytes + kGemmSmemAlign;
  p->grid_x = (int)cols;
  p->grid_y = (int)row_tiles;
  p->threads = 128 * (p->rows / kGemmWarpGroupRows) + 32;
  return true;
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

template <typename In> struct GemmOperand;
template <> struct GemmOperand<__nv_bfloat16> {
  typedef float Acc;
  static constexpr int kMmaK = 16;  // values of one wgmma's K
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
// The products
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

// Epi: a functor with fields m and n (the output's rows and columns) and
// operator()(row, col, acc[col], acc[col + 1]) storing two neighbouring
// outputs of one row. kGroups consumer warpgroups, 64 rows each, one column
// tile of 128.
template <typename In, int kGroups, typename Epi>
__device__ __forceinline__ void gemm_wgmma_body(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                                int k_steps, const Epi& epi) {
  typename GemmOperand<In>::Acc d[64];
  const int m0 = blockIdx.y * kGemmWarpGroupRows * kGroups, n0 = blockIdx.x * kGemmTileN;
  if (!gemm_wgmma_mainloop<In, kGroups, 1, GemmStages<kGroups>::value>(map_a, map_b, k_steps,
                                                                        m0, n0, d)) {
    return;
  }
  const int tid = threadIdx.x, group = tid / 128;
  const int w = (tid % 128) / 32, lane = tid % 32;
  const int r0 = m0 + group * kGemmWarpGroupRows + 16 * w + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < kGemmTileN / 8; ++i) {
    if (n0 + 8 * i >= epi.n) break;  // a last tile of 64 columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < epi.m) epi(r, c0 + 8 * i, d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
    }
  }
}

template <int kGroups, typename Epi>
__global__ void __launch_bounds__(128 * kGroups + 32, GemmBlocksPerSm<kGroups>::value)
    gemm_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b, int k_steps, Epi epi) {
  gemm_wgmma_body<__nv_bfloat16, kGroups>(&map_a, &map_b, k_steps, epi);
}

template <int kGroups, typename Epi>
__global__ void __launch_bounds__(128 * kGroups + 32, GemmBlocksPerSm<kGroups>::value)
    gemm_wgmma_s8_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b, int k_steps, Epi epi) {
  gemm_wgmma_body<int8_t, kGroups>(&map_a, &map_b, k_steps, epi);
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

// False for a shape the int8 GEMM refuses (gemm_plan).
inline bool rowquant_gemm_plan(int m, int n, int k, RowquantGemmPlan* p) {
  GemmPlan g;
  if (!gemm_plan(m, n, k, 1, &g)) return false;
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

template <typename In, int kGroups, typename Epi>
int launch_gemm_wgmma_as(const CUtensorMap& ma, const CUtensorMap& mb, int k_steps, const Epi& epi,
                         const GemmPlan& p, cudaStream_t st) {
  void (*kernel)(const CUtensorMap, const CUtensorMap, int, Epi);
  if constexpr (std::is_same<In, int8_t>::value) {
    kernel = gemm_wgmma_s8_kernel<kGroups, Epi>;
  } else {
    kernel = gemm_wgmma_bf16_kernel<kGroups, Epi>;
  }
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  IRT_TRY(kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, st>>>(ma, mb, k_steps, epi));
  return 0;
}

// C = epi(A Bt^T) for A (epi.m, k) and Bt (epi.n, k) of type In (bf16 or
// int8). IRT_BAD_ARGS for a shape gemm_plan refuses or an operand TMA cannot
// address (its base not 16-byte aligned).
template <typename In, typename Epi>
int launch_gemm_wgmma(const In* a, const In* bt, int k, const Epi& epi, cudaStream_t st) {
  GemmPlan p;
  if (!gemm_plan(epi.m, epi.n, k, std::is_same<In, int8_t>::value ? 1 : 0, &p)) {
    return IRT_BAD_ARGS;
  }
  if ((uintptr_t)a % 16 || (uintptr_t)bt % 16) return IRT_BAD_ARGS;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap ma, mb;
  if (!encode_operand(&ma, a, epi.m, k, p.rows) || !encode_operand(&mb, bt, epi.n, k, kGemmTileN)) {
    return IRT_BAD_ARGS;
  }
  const int k_steps = (k * (int)sizeof(In) + kGemmRowBytes - 1) / kGemmRowBytes;
  if (p.rows == 256) return launch_gemm_wgmma_as<In, 4>(ma, mb, k_steps, epi, p, st);
  return p.rows == 128 ? launch_gemm_wgmma_as<In, 2>(ma, mb, k_steps, epi, p, st)
                       : launch_gemm_wgmma_as<In, 1>(ma, mb, k_steps, epi, p, st);
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

// Two neighbouring outputs of one row, as one 4-byte (bf16) or 8-byte (f32)
// store.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16(a);
  v.y = __float2bfloat16(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

}  // namespace
