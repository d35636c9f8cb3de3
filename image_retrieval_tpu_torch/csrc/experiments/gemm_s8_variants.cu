// Design experiments of the int8 GEMM (gemm_persistent_kernel on int8
// operands, gemm_sm90.cuh). Not part of the library: chip_smoke.py
// --gemm-s8-variants builds this file alone with the library's nvcc flags
// and runs it on the card.
//
// At the int8 projection shapes of the main paths (q/k/v, the out-projection
// and fc2 of the L/14 image batch, B = 128, and of the B/32 one, B = 256; the
// B/32 vision and text layers at B = 8; the L/14 text batch's
// out-projection) it times the kernel on the library's plan beside the
// variants the design was chosen from, launched in turns, each on the same
// seeded operands and held bit for bit against the library's output (int32
// sums are exact and every variant runs the same epilogue arithmetic, so the
// bits must not move):
//   - "256 rows, 4 x 64" ... "64 rows": that tile height at every shape
//                     (persistent, no tile plan by shape); 256-row tiles on
//                     four consumer warpgroups of 64 rows (17 warps: ptxas
//                     caps a thread at 96 registers, five warps sharing an SM
//                     sub-partition, and the epilogues spill);
//   - "multicast": the plan's tile height in clusters of two blocks on
//                     neighbouring column tiles, each loading half the A tile
//                     and multicasting it to both (the bf16 GEMM's design
//                     before this one), the clusters the card holds;
//   - "a block a tile": the plan's tile height, one block per tile (not
//                     persistent: no block overlaps its epilogue with the
//                     next tile's loads);
//   - "one-tile": the kernel this design replaced (one block a 64-256 x 128
//                     tile, a four- or three-stage ring, the epilogue reading
//                     its scales, bias and residual from device memory and
//                     storing 4-byte pairs), copied here with its plan.
// Prints one line per (shape, variant): ms (CUDA events, median of five
// samples of ten launches, in turns with the library's plan) and "bits
// equal yes" or "NO". First, the host side of one launch at a small
// batch's shape (M = 400) in microseconds of the host clock, and fc2 at that
// batch with f32 and bf16 outputs beside the one-tile kernel.

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <functional>
#include <vector>

#include "../int8_common.cuh"

namespace {

// ---- the one-tile int8 GEMM this design replaced ---------------------------

template <int kGroups> struct OneTileStages { static constexpr int value = kGroups == 2 ? 3 : 4; };
template <int kGroups> struct OneTileBlocksPerSm { static constexpr int value = kGroups == 4 ? 1 : 2; };

template <typename OutT, int kEpi>
struct OneTileEpilogue {
  const float* row_scale;
  const float* col_scale;
  const float* bias;
  const OutT* residual;
  OutT* c;
  int m, n;
  __device__ __forceinline__ float finish(int acc, float rs, int col, size_t o) const {
    float v = int8_dequant<kEpi == kGelu ? kGelu : kStore>(acc, rs, col_scale[col], bias[col]);
    if (kEpi == kResidual) v = __fadd_rn(to_f32(residual[o]), round_to<OutT>(v));
    return v;
  }
  __device__ __forceinline__ void operator()(int row, int col, int a0, int a1) const {
    const size_t o = (size_t)row * n + col;
    const float rs = row_scale[row];
    const float v0 = finish(a0, rs, col, o), v1 = finish(a1, rs, col + 1, o + 1);
    if constexpr (sizeof(OutT) == 2) {
      __nv_bfloat162 v;
      v.x = __float2bfloat16(v0);
      v.y = __float2bfloat16(v1);
      *reinterpret_cast<__nv_bfloat162*>(c + o) = v;
    } else {
      *reinterpret_cast<float2*>(c + o) = make_float2(v0, v1);
    }
  }
};

template <int kGroups, typename Epi>
__global__ void __launch_bounds__(128 * kGroups + 32, OneTileBlocksPerSm<kGroups>::value)
    onetile_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, int k_steps, Epi epi) {
  int d[64];
  const int m0 = blockIdx.y * kGemmWarpGroupRows * kGroups, n0 = blockIdx.x * kGemmTileN;
  if (!gemm_wgmma_mainloop<int8_t, kGroups, 1, OneTileStages<kGroups>::value>(
          &map_a, &map_b, k_steps, m0, n0, d)) {
    return;
  }
  const int tid = threadIdx.x, group = tid / 128;
  const int w = (tid % 128) / 32, lane = tid % 32;
  const int r0 = m0 + group * kGemmWarpGroupRows + 16 * w + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < kGemmTileN / 8; ++i) {
    if (n0 + 8 * i >= epi.n) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < epi.m) epi(r, c0 + 8 * i, d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
    }
  }
}

// 256 rows where those give the 132 SMs a block each, else 128, else 64.
template <int kGroups, typename Epi>
int onetile_launch_as(const CUtensorMap& ma, const CUtensorMap& mb, int k_steps, const Epi& epi,
                      int grid_x, int grid_y) {
  constexpr int smem = OneTileStages<kGroups>::value * (64 * kGroups + kGemmTileN) *
                           kGemmRowBytes + kGemmSmemAlign;
  void (*kernel)(const CUtensorMap, const CUtensorMap, int, Epi) = onetile_kernel<kGroups, Epi>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<dim3(grid_x, grid_y), 128 * kGroups + 32, smem>>>(ma, mb, k_steps, epi);
  return (int)cudaGetLastError();
}

template <typename OutT, int kEpi>
int onetile_launch(const int8_t* a, const int8_t* bt, const float* rs, const float* cs,
                   const float* bias, const OutT* res, OutT* c, int m, int n, int k) {
  const int cols = (n + kGemmTileN - 1) / kGemmTileN;
  const int rows = (long long)(m + 255) / 256 * cols >= 132   ? 256
                   : (long long)(m + 127) / 128 * cols >= 132 ? 128
                                                              : 64;
  CUtensorMap ma, mb;
  if (!encode_operand(&ma, a, m, k, rows) || !encode_operand(&mb, bt, n, k, kGemmTileN)) {
    return IRT_BAD_ARGS;
  }
  const OneTileEpilogue<OutT, kEpi> epi{rs, cs, bias, res, c, m, n};
  const int k_steps = (k + kGemmRowBytes - 1) / kGemmRowBytes, gy = (m + rows - 1) / rows;
  if (rows == 256) return onetile_launch_as<4>(ma, mb, k_steps, epi, cols, gy);
  if (rows == 128) return onetile_launch_as<2>(ma, mb, k_steps, epi, cols, gy);
  return onetile_launch_as<1>(ma, mb, k_steps, epi, cols, gy);
}

// ---- the persistent forms --------------------------------------------------

__global__ void fill_s8(int8_t* p, size_t n, uint32_t seed) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t h = (uint32_t)i * 2654435761u ^ seed;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    p[i] = (int8_t)((int)(h % 255u) - 127);
  }
}

__global__ void fill_f32(float* p, size_t n, uint32_t seed, float lo, float hi) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t h = (uint32_t)i * 2246822519u ^ seed;
    h ^= h >> 13;
    h *= 2654435761u;
    p[i] = lo + (hi - lo) * ((float)(h & 0xffff) / 65536.f);
  }
}

__global__ void fill_bf16(__nv_bfloat16* p, size_t n, uint32_t seed) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t h = (uint32_t)i * 2654435761u ^ seed;
    h ^= h >> 15;
    p[i] = __float2bfloat16((float)(h & 0xffff) / 32768.f - 1.f);
  }
}

struct Shape {
  const char* name;
  int m, n, k, epi;  // epi: kStore or kResidual, bf16 outputs as on the main path
};

// The form kG in clusters of kCluster on min(slots, cluster tiles) clusters
// (slots 0: one cluster a cluster tile).
template <int kG, int kCluster, typename Epi>
int run_forced(const int8_t* a, const int8_t* bt, const __nv_bfloat16* res, __nv_bfloat16* c,
               int k, const Epi& epi, int slots) {
  const int cols = (epi.n + kGemmTileN - 1) / kGemmTileN;
  const int bands = (epi.m + 64 * kG - 1) / (64 * kG);
  const int tiles = bands * ((cols + kCluster - 1) / kCluster);
  const int blocks = kCluster * (slots > 0 ? std::min(tiles, slots) : tiles);
  return launch_gemm_form<int8_t, kG, kCluster>(a, bt, res, c, k, epi, cols, bands, blocks, 0);
}

// The library's form of the plan's tile height, picked at run time.
template <int kCluster, typename Epi>
int run_plan_height(int rows, const int8_t* a, const int8_t* bt, const __nv_bfloat16* res,
                    __nv_bfloat16* c, int k, const Epi& epi, int slots) {
  switch (rows) {
    case 192:
      return run_forced<3, kCluster>(a, bt, res, c, k, epi, slots);
    case 128:
      return run_forced<2, kCluster>(a, bt, res, c, k, epi, slots);
    default:
      return run_forced<1, kCluster>(a, bt, res, c, k, epi, slots);
  }
}

template <typename F>
float time_ms(F f) {
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  std::vector<float> v;
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(s);
    for (int i = 0; i < 10; ++i) f();
    cudaEventRecord(e);
    cudaEventSynchronize(e);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, s, e);
    v.push_back(ms / 10);
  }
  cudaEventDestroy(s);
  cudaEventDestroy(e);
  std::sort(v.begin(), v.end());
  return v[2];
}

template <int kEpi>
bool run_shape(const Shape& sh, const int* slots, int slots2) {
  typedef Int8Epilogue<__nv_bfloat16, kEpi> Epi;
  const int m = sh.m, n = sh.n, k = sh.k;
  int8_t *a, *bt;
  __nv_bfloat16 *res, *want, *got;
  float *rs, *cs, *bias;
  cudaMalloc(&a, (size_t)m * k);
  cudaMalloc(&bt, (size_t)n * k);
  cudaMalloc(&res, (size_t)m * n * 2);
  cudaMalloc(&want, (size_t)m * n * 2);
  cudaMalloc(&got, (size_t)m * n * 2);
  cudaMalloc(&rs, (size_t)m * 4);
  cudaMalloc(&cs, (size_t)n * 4);
  cudaMalloc(&bias, (size_t)n * 4);
  fill_s8<<<1024, 256>>>(a, (size_t)m * k, 1);
  fill_s8<<<1024, 256>>>(bt, (size_t)n * k, 2);
  fill_bf16<<<1024, 256>>>(res, (size_t)m * n, 3);
  // scales of the size rowquant and quantize_weight give
  fill_f32<<<64, 256>>>(rs, m, 4, 1e-3f, 0.021f);
  fill_f32<<<64, 256>>>(cs, n, 5, 1e-3f / sqrtf((float)k), 0.021f / sqrtf((float)k));
  fill_f32<<<64, 256>>>(bias, n, 6, -0.02f, 0.02f);
  const Epi epi{rs, cs, bias, m, n};
  GemmTilePlan plan;
  gemm_tile_plan(m, n, k, slots[0], Epi::kColParams, &plan);
  auto library = [&](__nv_bfloat16* out) {
    return launch_gemm_tc<int8_t>(a, bt, res, out, k, epi, 0);
  };
  int rc = library(want);
  if (rc != 0 || cudaDeviceSynchronize() != cudaSuccess) {
    printf("%s: the library's launch failed (%d) NO\n", sh.name, rc);
    return false;
  }
  struct Variant {
    const char* name;
    std::function<int(__nv_bfloat16*)> run;
  };
  const int prow = plan.rows;
  const Variant variants[] = {
      {"256 rows, 4 x 64",
       [&](__nv_bfloat16* o) { return run_forced<4, 1>(a, bt, res, o, k, epi, slots[4]); }},
      {"192 rows", [&](__nv_bfloat16* o) { return run_forced<3, 1>(a, bt, res, o, k, epi, slots[3]); }},
      {"128 rows", [&](__nv_bfloat16* o) { return run_forced<2, 1>(a, bt, res, o, k, epi, slots[2]); }},
      {"64 rows", [&](__nv_bfloat16* o) { return run_forced<1, 1>(a, bt, res, o, k, epi, slots[1]); }},
      {"multicast",
       [&](__nv_bfloat16* o) { return run_plan_height<2>(prow, a, bt, res, o, k, epi, slots2); }},
      {"a block a tile",
       [&](__nv_bfloat16* o) { return run_plan_height<1>(prow, a, bt, res, o, k, epi, 0); }},
      {"one-tile (replaced)",
       [&](__nv_bfloat16* o) {
         return onetile_launch<__nv_bfloat16, kEpi>(a, bt, rs, cs, bias, res, o, m, n, k);
       }},
  };
  bool ok = true;
  const float lib_ms = time_ms([&] { library(got); });
  printf("%-22s m %5d n %4d k %4d library plan (rows %d, %d stages, %d blocks, %d waves): "
         "%.4f ms\n",
         sh.name, m, n, k, plan.rows, plan.stages, plan.blocks, plan.waves, lib_ms);
  for (const Variant& v : variants) {
    cudaMemset(got, 0, (size_t)m * n * 2);
    rc = v.run(got);
    if (rc != 0 || cudaDeviceSynchronize() != cudaSuccess) {
      printf("%-22s %s: launch failed (%d) NO\n", sh.name, v.name, rc);
      ok = false;
      continue;
    }
    std::vector<uint16_t> hw((size_t)m * n), hg((size_t)m * n);
    cudaMemcpy(hw.data(), want, hw.size() * 2, cudaMemcpyDeviceToHost);
    cudaMemcpy(hg.data(), got, hg.size() * 2, cudaMemcpyDeviceToHost);
    const bool same = hw == hg;
    ok = ok && same;
    float ms[2], lib[2];
    for (int turn = 0; turn < 2; ++turn) {  // in turns with the library's plan
      ms[turn] = time_ms([&] { v.run(got); });
      lib[turn] = time_ms([&] { library(got); });
    }
    printf("%-22s %-20s %.4f / %.4f ms (library %.4f / %.4f), bits equal %s\n", sh.name,
           v.name, ms[0], ms[1], lib[0], lib[1], same ? "yes" : "NO");
  }
  for (void* p : {(void*)a, (void*)bt, (void*)res, (void*)want, (void*)got, (void*)rs,
                  (void*)cs, (void*)bias}) {
    cudaFree(p);
  }
  return ok;
}

template <typename F>
double host_us(F f) {
  const int n = 200;
  cudaDeviceSynchronize();
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i) f();
  const auto t1 = std::chrono::steady_clock::now();
  cudaDeviceSynchronize();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / n;
}

void host_side() {
  const int m = 400, n = 768, k = 768;
  int8_t *a, *bt;
  __nv_bfloat16* c;
  float *rs, *cs, *bias;
  cudaMalloc(&a, (size_t)m * k);
  cudaMalloc(&bt, (size_t)n * k);
  cudaMalloc(&c, (size_t)m * n * 2);
  cudaMalloc(&rs, m * 4);
  cudaMalloc(&cs, n * 4);
  cudaMalloc(&bias, n * 4);
  cudaMemset(a, 0, (size_t)m * k);
  cudaMemset(bt, 0, (size_t)n * k);
  cudaMemset(rs, 0, m * 4);
  cudaMemset(cs, 0, n * 4);
  cudaMemset(bias, 0, n * 4);
  const Int8Epilogue<__nv_bfloat16, kStore> epi{rs, cs, bias, m, n};
  auto persistent = [&] { launch_gemm_tc<int8_t>(a, bt, nullptr, c, k, epi, 0); };
  auto onetile = [&] {
    onetile_launch<__nv_bfloat16, kStore>(a, bt, rs, cs, bias, nullptr, c, m, n, k);
  };
  persistent();
  onetile();
  const double t_new = host_us(persistent), t_old = host_us(onetile);
  printf("host us a launch at m %d n %d k %d: the persistent int8 GEMM %.2f, the one-tile one "
         "%.2f\n",
         m, n, k, t_new, t_old);
  for (void* p : {(void*)a, (void*)bt, (void*)c, (void*)rs, (void*)cs, (void*)bias}) {
    cudaFree(p);
  }
}

// fc2 at the B = 8 layers' shape with f32 outputs and the residual (the
// persistent kernel's register-store epilogue, no TMA on the output side)
// and with bf16 outputs (the TMA epilogue), each beside the one-tile kernel:
// whether the TMA epilogue is what the one-tile kernel wins by at small M.
void small_m_epilogues() {
  const int m = 400, n = 768, k = 3072;
  int8_t *a, *bt;
  float *rs, *cs, *bias, *r32, *c32;
  __nv_bfloat16 *r16, *c16;
  cudaMalloc(&a, (size_t)m * k);
  cudaMalloc(&bt, (size_t)n * k);
  cudaMalloc(&rs, m * 4);
  cudaMalloc(&cs, n * 4);
  cudaMalloc(&bias, n * 4);
  cudaMalloc(&r32, (size_t)m * n * 4);
  cudaMalloc(&c32, (size_t)m * n * 4);
  cudaMalloc(&r16, (size_t)m * n * 2);
  cudaMalloc(&c16, (size_t)m * n * 2);
  fill_s8<<<256, 256>>>(a, (size_t)m * k, 7);
  fill_s8<<<256, 256>>>(bt, (size_t)n * k, 8);
  fill_f32<<<64, 256>>>(rs, m, 9, 1e-3f, 0.021f);
  fill_f32<<<64, 256>>>(cs, n, 10, 1e-3f / sqrtf((float)k), 0.021f / sqrtf((float)k));
  fill_f32<<<64, 256>>>(bias, n, 11, -0.02f, 0.02f);
  fill_f32<<<256, 256>>>(r32, (size_t)m * n, 12, -1.f, 1.f);
  fill_bf16<<<256, 256>>>(r16, (size_t)m * n, 13);
  const Int8Epilogue<float, kResidual> e32{rs, cs, bias, m, n};
  const Int8Epilogue<__nv_bfloat16, kResidual> e16{rs, cs, bias, m, n};
  float t[4][2];
  for (int turn = 0; turn < 2; ++turn) {
    t[0][turn] = time_ms([&] { launch_gemm_tc<int8_t>(a, bt, r32, c32, k, e32, 0); });
    t[1][turn] = time_ms(
        [&] { onetile_launch<float, kResidual>(a, bt, rs, cs, bias, r32, c32, m, n, k); });
    t[2][turn] = time_ms([&] { launch_gemm_tc<int8_t>(a, bt, r16, c16, k, e16, 0); });
    t[3][turn] = time_ms([&] {
      onetile_launch<__nv_bfloat16, kResidual>(a, bt, rs, cs, bias, r16, c16, m, n, k);
    });
  }
  printf("fc2 at m %d n %d k %d, residual: f32 outputs persistent %.4f / %.4f ms, one-tile "
         "%.4f / %.4f; bf16 outputs persistent %.4f / %.4f, one-tile %.4f / %.4f\n",
         m, n, k, t[0][0], t[0][1], t[1][0], t[1][1], t[2][0], t[2][1], t[3][0], t[3][1]);
  for (void* p : {(void*)a, (void*)bt, (void*)rs, (void*)cs, (void*)bias, (void*)r32, (void*)c32,
                  (void*)r16, (void*)c16}) {
    cudaFree(p);
  }
}

}  // namespace

int main() {
  typedef Int8Epilogue<__nv_bfloat16, kStore> E;
  // slots[g]: blocks of the g-warpgroup form the card holds at once;
  // slots[0]: the library's (the fewest over its forms); slots2: clusters of
  // two of the 192-row form
  const int slots[5] = {gemm_slots<int8_t, E>(), gemm_max_blocks_as<int8_t, 1, E>(),
                        gemm_max_blocks_as<int8_t, 2, E>(), gemm_max_blocks_as<int8_t, 3, E>(),
                        gemm_max_blocks_as<int8_t, 4, E>()};
  const int slots2 = gemm_max_clusters_as<int8_t, 3, 2, E>();
  printf("blocks the card holds at once: %d (64-256 rows: %d %d %d %d); clusters of two: %d\n",
         slots[0], slots[1], slots[2], slots[3], slots[4], slots2);
  if (slots[0] < 1 || slots[4] < 1 || slots2 < 1) return 1;
  host_side();
  small_m_epilogues();
  const Shape shapes[] = {
      {"l14-vision-B128 qkv", 32896, 3072, 1024, kStore},
      {"l14-vision-B128 out", 32896, 1024, 1024, kResidual},
      {"l14-vision-B128 fc2", 32896, 1024, 4096, kResidual},
      {"b32-vision-B256 qkv", 12800, 2304, 768, kStore},
      {"b32-vision-B256 out", 12800, 768, 768, kResidual},
      {"b32-vision-B256 fc2", 12800, 768, 3072, kResidual},
      {"l14-text-B64 out", 4928, 768, 768, kResidual},
      {"b32-vision-B8 qkv", 400, 2304, 768, kStore},
      {"b32-vision-B8 out", 400, 768, 768, kResidual},
      {"b32-vision-B8 fc2", 400, 768, 3072, kResidual},
      {"b32-text-B8 qkv", 616, 1536, 512, kStore},
      {"b32-text-B8 fc2", 616, 512, 2048, kResidual},
  };
  bool ok = true;
  for (const Shape& s : shapes) {
    if (s.epi == kStore) ok = run_shape<kStore>(s, slots, slots2) && ok;
    if (s.epi == kResidual) ok = run_shape<kResidual>(s, slots, slots2) && ok;
  }
  return ok ? 0 : 1;
}
