// Design experiments of the bf16 GEMM (gemm_persistent_kernel on bf16
// operands, gemm_sm90.cuh). Not
// part of the library: chip_smoke.py --gemm-variants builds this file alone
// with the library's nvcc flags and runs it on the card.
//
// At the projection shapes of the main paths (the L/14 and B/32 image
// batches, the trainer's out-projection, the L/14 text batch, a B/32 batch
// of 8 images) it times the
// kernel on the library's plan beside the variants the design was chosen
// from, launched in turns, each on the same seeded operands and held bit for
// bit against the library's output (every variant runs the same wgmma
// instruction over the same K order, so the bits must not move):
//   - "256 rows, 4 x 64": 256-row tiles on four warpgroups of 64 rows (17
//                     warps, five on one SM sub-partition: ptxas caps a
//                     thread at 96 registers, which its epilogues spill past;
//                     three stages beside four output slabs);
//   - "192 rows", "128 rows": those tile heights at every shape (no tile
//                     plan by shape);
//   - "multicast": 192-row tiles in clusters of two blocks on neighbouring
//                     column tiles, each loading half the A tile and
//                     multicasting it to both (112 flop per L2 byte instead
//                     of 79; the design before clusters of one), the
//                     clusters the card holds;
//   - "a block a tile": 192-row tiles, one block per tile (not persistent:
//                     no block overlaps its epilogue with the next tile's
//                     loads).
// Prints one line per (shape, variant): ms (CUDA events, median of five
// samples of ten launches) and "bits equal yes" or "NO". First, the host
// side of one launch at a small batch's shape (M = 400), in microseconds of
// the host clock over 200 calls: the whole launch, and alone its pieces (a
// tensor map encoded, cudaFuncSetAttribute), beside the int8 GEMM's launch.

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <vector>

#include "../dense_common.cuh"
#include "../int8_common.cuh"

namespace {

__global__ void fill_bf16(__nv_bfloat16* p, size_t n, uint32_t seed, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t h = (uint32_t)i * 2654435761u ^ seed;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    p[i] = __float2bfloat16(scale * ((float)(h & 0xffff) / 32768.f - 1.f));
  }
}

__global__ void fill_f32(float* p, size_t n, uint32_t seed, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t h = (uint32_t)i * 2246822519u ^ seed;
    h ^= h >> 13;
    p[i] = scale * ((float)(h & 0xffff) / 32768.f - 1.f);
  }
}

struct Shape {
  const char* name;
  int m, n, k, epi;  // epi: kBias, kBiasGelu or kBiasResidual
};

// The form kG in clusters of kCluster on min(slots, cluster tiles) clusters
// (slots 0: one cluster a cluster tile).
template <int kG, int kCluster, typename Epi>
int run_forced(const __nv_bfloat16* a, const __nv_bfloat16* bt, const __nv_bfloat16* res,
               __nv_bfloat16* c, int k, const Epi& epi, int slots) {
  const int cols = (epi.n + kGemmTileN - 1) / kGemmTileN;
  const int bands = (epi.m + 64 * kG - 1) / (64 * kG);
  const int tiles = bands * ((cols + kCluster - 1) / kCluster);
  const int blocks = kCluster * (slots > 0 ? std::min(tiles, slots) : tiles);
  return launch_gemm_form<__nv_bfloat16, kG, kCluster>(a, bt, res, c, k, epi, cols, bands,
                                                      blocks, 0);
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
bool run_shape(const Shape& sh, int slots, int slots4, int slots2) {
  const int m = sh.m, n = sh.n, k = sh.k;
  __nv_bfloat16 *a, *bt, *res, *want, *got;
  float* bias;
  cudaMalloc(&a, (size_t)m * k * 2);
  cudaMalloc(&bt, (size_t)n * k * 2);
  cudaMalloc(&res, (size_t)m * n * 2);
  cudaMalloc(&want, (size_t)m * n * 2);
  cudaMalloc(&got, (size_t)m * n * 2);
  cudaMalloc(&bias, (size_t)n * 4);
  fill_bf16<<<1024, 256>>>(a, (size_t)m * k, 1, 1.f);
  fill_bf16<<<1024, 256>>>(bt, (size_t)n * k, 2, 1.f / sqrtf((float)k));
  fill_bf16<<<1024, 256>>>(res, (size_t)m * n, 3, 1.f);
  fill_f32<<<64, 256>>>(bias, n, 4, 0.02f);
  const DenseEpilogueBf16<kEpi> epi{bias, m, n};
  GemmTilePlan plan;
  gemm_tile_plan(m, n, k, slots, epi.kColParams, &plan);
  auto library = [&](__nv_bfloat16* out) {
    return launch_gemm_tc<__nv_bfloat16>(a, bt, res, out, k, epi, 0);
  };
  int rc = library(want);
  if (rc != 0 || cudaDeviceSynchronize() != cudaSuccess) {
    printf("%s: the library's launch failed (%d)\n", sh.name, rc);
    return false;
  }
  struct Variant {
    const char* name;
    int (*run)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
               __nv_bfloat16*, int, const DenseEpilogueBf16<kEpi>&, int);
    int slots;
  };
  const Variant variants[] = {
      {"256 rows, 4 x 64", run_forced<4, 1, DenseEpilogueBf16<kEpi>>, slots4},
      {"192 rows", run_forced<3, 1, DenseEpilogueBf16<kEpi>>, slots},
      {"128 rows", run_forced<2, 1, DenseEpilogueBf16<kEpi>>, slots},
      {"multicast", run_forced<3, 2, DenseEpilogueBf16<kEpi>>, slots2},
      {"a block a tile", run_forced<3, 1, DenseEpilogueBf16<kEpi>>, 0},
  };
  bool ok = true;
  const float lib_ms = time_ms([&] { library(got); });
  printf("%-22s m %5d n %4d k %4d library plan (rows %d, %d blocks, %d waves): %.4f ms\n",
         sh.name, m, n, k, plan.rows, plan.blocks, plan.waves, lib_ms);
  for (const Variant& v : variants) {
    cudaMemset(got, 0, (size_t)m * n * 2);
    rc = v.run(a, bt, res, got, k, epi, v.slots);
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
    float ms[2];
    for (int turn = 0; turn < 2; ++turn) {  // in turns with the library's plan
      ms[turn] = time_ms([&] { v.run(a, bt, res, got, k, epi, v.slots); });
      if (turn == 0) time_ms([&] { library(got); });
    }
    printf("%-22s %-18s %.4f / %.4f ms, bits equal %s\n", sh.name, v.name, ms[0], ms[1],
           same ? "yes" : "NO");
  }
  cudaFree(a);
  cudaFree(bt);
  cudaFree(res);
  cudaFree(want);
  cudaFree(got);
  cudaFree(bias);
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
  __nv_bfloat16 *a, *bt, *c;
  int8_t *a8, *b8;
  float *bias, *rs, *cs, *c32;
  cudaMalloc(&a, (size_t)m * k * 2);
  cudaMalloc(&bt, (size_t)n * k * 2);
  cudaMalloc(&c, (size_t)m * n * 2);
  cudaMalloc(&a8, (size_t)m * k);
  cudaMalloc(&b8, (size_t)n * k);
  cudaMalloc(&c32, (size_t)m * n * 4);
  cudaMalloc(&bias, n * 4);
  cudaMalloc(&rs, m * 4);
  cudaMalloc(&cs, n * 4);
  cudaMemset(a, 0, (size_t)m * k * 2);
  cudaMemset(bt, 0, (size_t)n * k * 2);
  cudaMemset(a8, 0, (size_t)m * k);
  cudaMemset(b8, 0, (size_t)n * k);
  cudaMemset(bias, 0, n * 4);
  cudaMemset(rs, 0, m * 4);
  cudaMemset(cs, 0, n * 4);
  const DenseEpilogueBf16<kBias> epi{bias, m, n};
  launch_gemm_tc<__nv_bfloat16>(a, bt, nullptr, c, k, epi, 0);
  CUtensorMap map;
  const GemmKernelFn<__nv_bfloat16, 1, 1, DenseEpilogueBf16<kBias>> kernel =
      gemm_persistent_kernel<__nv_bfloat16, 1, 1, DenseEpilogueBf16<kBias>>;
  auto bf16 = [&] { launch_gemm_tc<__nv_bfloat16>(a, bt, nullptr, c, k, epi, 0); };
  auto s8 = [&] {
    launch_gemm_s8<float, kStore>(a8, b8, rs, cs, bias, nullptr, c32, m, n, k, 0);
  };
  auto encode = [&] { encode_operand(&map, a, m, k, 32); };
  auto attribute = [&] {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         GemmBlock<1, 1>::kSmem);
  };
  const double t_bf16 = host_us(bf16), t_s8 = host_us(s8), t_encode = host_us(encode);
  const double t_attr = host_us(attribute);
  printf("host us a launch at m %d n %d k %d: bf16 GEMM %.2f, int8 GEMM %.2f; alone: a tensor "
         "map encoded %.2f, cudaFuncSetAttribute %.2f\n",
         m, n, k, t_bf16, t_s8, t_encode, t_attr);
  for (void* p : {(void*)a, (void*)bt, (void*)c, (void*)a8, (void*)b8, (void*)c32, (void*)bias,
                  (void*)rs, (void*)cs}) {
    cudaFree(p);
  }
}

}  // namespace

int main() {
  typedef __nv_bfloat16 bf16;
  const int slots = gemm_slots<bf16, DenseEpilogueBf16<kBias>>();
  const int slots4 = gemm_max_blocks_as<bf16, 4, DenseEpilogueBf16<kBias>>();
  const int slots2 = gemm_max_clusters_as<bf16, 3, 2, DenseEpilogueBf16<kBias>>();
  printf("blocks the card holds at once: %d; of the 256-row form: %d; clusters of two: %d\n",
         slots, slots4, slots2);
  if (slots < 1 || slots4 < 1 || slots2 < 1) return 1;
  host_side();
  const Shape shapes[] = {
      {"l14-vision-B128 qkv", 32896, 3072, 1024, kBias},
      {"l14-vision-B128 out", 32896, 1024, 1024, kBiasResidual},
      {"l14-vision-B128 fc1", 32896, 4096, 1024, kBiasGelu},
      {"l14-vision-B128 fc2", 32896, 1024, 4096, kBiasResidual},
      {"b32-vision-B256 qkv", 12800, 2304, 768, kBias},
      {"b32-vision-B256 out", 12800, 768, 768, kBiasResidual},
      {"b32-vision-B256 fc1", 12800, 3072, 768, kBiasGelu},
      {"b32-vision-B256 fc2", 12800, 768, 3072, kBiasResidual},
      {"b32-vision-B128 out", 6400, 768, 768, kBiasResidual},
      {"l14-text-B64 out", 4928, 768, 768, kBiasResidual},
      {"b32-vision-B8 qkv", 400, 2304, 768, kBias},
      {"b32-vision-B8 fc1", 400, 3072, 768, kBiasGelu},
      {"b32-vision-B8 fc2", 400, 768, 3072, kBiasResidual},
  };
  bool ok = true;
  for (const Shape& s : shapes) {
    if (s.epi == kBias) ok = run_shape<kBias>(s, slots, slots4, slots2) && ok;
    if (s.epi == kBiasGelu) ok = run_shape<kBiasGelu>(s, slots, slots4, slots2) && ok;
    if (s.epi == kBiasResidual) ok = run_shape<kBiasResidual>(s, slots, slots4, slots2) && ok;
  }
  return ok ? 0 : 1;
}
