// Design experiments for the int8 MLP's fused fc1 -> quick_gelu -> rowquant
// stage (gemm_wgmma_s8_rowquant_kernel, gemm_sm90.cuh). Not part of the
// library: a standalone program that times, on one card, the production
// launch, the two launches it replaces, and the variants its design was
// chosen from, each held bit for bit against the production output, at the
// fc1 shapes of the ViT-L/14 image batch (m 32,896, n 4,096, k 1,024) and
// the ViT-B/32 one (m 12,800, n 3,072, k 768). Seeded int8 operands.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o variants rowquant_gemm_variants.cu && ./variants
//
// (`python3 chip_smoke.py --rowquant-variants` builds and runs it.)
//
// The variants (variant_kernel): kG warpgroups of 128 columns a block (the
// cluster covers n / (128 kG) blocks), kStages ring stages; the row maxima
// pushed into every block before one cluster barrier (kPush) or read from
// the peers after a barrier, with a second barrier before exit; the int8
// tile staged in the idle ring for 16-byte stores (kStaged) or stored two
// bytes at a time; the columns' scales and biases staged in shared memory
// (kSmemCols) or read per output. Each reports its mean per-block phase times
// (%globaltimer): products, finish and local max, exchange, quantize, stores.
// persistent_kernel: one wave of clusters walking the row tiles, the
// producer loading the next tile during the epilogue, maxima exchanged by
// DSMEM stores and mbarrier arrivals, the int8 rows stored 8 bytes a lane
// after a transpose within each quad.
#include <algorithm>
#include <cstdio>
#include <vector>

#include "../int8_common.cuh"

namespace {

__device__ long long g_stamps[1 << 13][6];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int kG, int kStages, int kPush, int kStaged, int kSmemCols>
__global__ void __launch_bounds__(128 * kG + 32, 1)
    variant_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, int k_steps, GeluFinish fin,
                   int8_t* __restrict__ q, float* __restrict__ qs) {
  constexpr int kCols = 128 * kG, kRow = kCols + 16;
  __shared__ __align__(16) float col_scale[kCols];
  __shared__ __align__(16) float col_bias[kCols];
  __shared__ float group_max[kG][64];
  __shared__ float block_max[64];
  __shared__ float row_max[kRqMaxCluster][64];
  extern __shared__ uint8_t gemm_smem[];
  const long long t0 = global_ns();
  const int tid = threadIdx.x, blin = blockIdx.y * gridDim.x + blockIdx.x;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * kCols;
  if (kPush) cluster_arrive_relaxed();
  if (kSmemCols && tid < kCols / 4) {
    reinterpret_cast<float4*>(col_scale)[tid] = reinterpret_cast<const float4*>(fin.col_scale + n0)[tid];
    reinterpret_cast<float4*>(col_bias)[tid] = reinterpret_cast<const float4*>(fin.bias + n0)[tid];
  }
  int d[64];
  const bool consumer =
      gemm_wgmma_mainloop<int8_t, 1, kG, kStages>(&map_a, &map_b, k_steps, m0, n0, d);
  const int group = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int lr = 16 * w + lane / 4, lc = group * 128 + 2 * (lane % 4);
  const uint32_t rank = cluster_rank(), blocks = cluster_blocks();
  const long long t1 = global_ns();
  float amax[2] = {0.f, 0.f};
  if (consumer) {
    float rs[2];
    for (int h = 0; h < 2; ++h) rs[h] = m0 + lr + 8 * h < fin.m ? fin.row_scale[m0 + lr + 8 * h] : 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lc + 8 * i + j;
          const float v = kSmemCols ? fin.finish(d[4 * i + 2 * h + j], rs[h], col_scale[c], col_bias[c])
                                    : fin.finish(d[4 * i + 2 * h + j], rs[h], n0 + c, 0);
          d[4 * i + 2 * h + j] = __float_as_int(v);
          amax[h] = fmaxf(amax[h], fabsf(v));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
      if (lane % 4 == 0) group_max[group][lr + 8 * h] = amax[h];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kG) : "memory");
    if (group == 0 && lane % 4 == 0) {
      for (int h = 0; h < 2; ++h) {
        float a = group_max[0][lr + 8 * h];
        for (int g = 1; g < kG; ++g) a = fmaxf(a, group_max[g][lr + 8 * h]);
        block_max[lr + 8 * h] = a;
      }
    }
  }
  const long long t2 = global_ns();
  __syncwarp();
  if (kPush) {
    cluster_wait();
    if (consumer && group == 0 && lane % 4 == 0) {
      for (int h = 0; h < 2; ++h) {
        for (uint32_t b = 0; b < blocks; ++b) {
          st_cluster_f32(&row_max[rank][lr + 8 * h], b, block_max[lr + 8 * h]);
        }
      }
    }
    __syncwarp();
    cluster_arrive();
    cluster_wait();
    if (consumer) {
      for (int h = 0; h < 2; ++h) {
        float a = row_max[0][lr + 8 * h];
        for (uint32_t b = 1; b < blocks; ++b) a = fmaxf(a, row_max[b][lr + 8 * h]);
        amax[h] = a;
      }
    }
  } else {
    cluster_arrive();
    cluster_wait();
    if (consumer) {
      for (int h = 0; h < 2; ++h) {
        float a = 0.f;
        for (uint32_t b = lane % 4; b < blocks; b += 4) {
          uint32_t remote;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                       : "=r"(remote) : "r"(smem_u32(&block_max[lr + 8 * h])), "r"(b));
          float v;
          asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
          a = fmaxf(a, v);
        }
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
        amax[h] = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
      }
    }
    __syncwarp();
    cluster_arrive();
  }
  const long long t3 = global_ns();
  long long t4 = t3;
  if (consumer) {
    uint8_t* staged = gemm_smem + (((smem_u32(gemm_smem) + 1023) & ~1023u) - smem_u32(gemm_smem));
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + lr + 8 * h;
      const float s = __fdiv_rn(fmaxf(amax[h], 1e-12f), 127.f);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        char2 pair;
        pair.x = (signed char)__float2int_rn(__fdiv_rn(__int_as_float(d[4 * i + 2 * h]), s));
        pair.y = (signed char)__float2int_rn(__fdiv_rn(__int_as_float(d[4 * i + 2 * h + 1]), s));
        if (kStaged) {
          *reinterpret_cast<char2*>(staged + (lr + 8 * h) * kRow + lc + 8 * i) = pair;
        } else if (r < fin.m) {
          *reinterpret_cast<char2*>(q + (size_t)r * fin.n + n0 + lc + 8 * i) = pair;
        }
      }
      if (rank == 0 && group == 0 && lane % 4 == 0 && r < fin.m) qs[r] = s;
    }
    t4 = global_ns();
    if (kStaged) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kG) : "memory");
      for (int c = tid; c < 64 * (kCols / 16); c += 128 * kG) {
        const int row = c / (kCols / 16), col = 16 * (c % (kCols / 16));
        if (m0 + row < fin.m) {
          *reinterpret_cast<uint4*>(q + (size_t)(m0 + row) * fin.n + n0 + col) =
              *reinterpret_cast<const uint4*>(staged + row * kRow + col);
        }
      }
    }
  }
  if (tid == 0 && blin < (1 << 13)) {
    const long long t[6] = {t0, t1, t2, t3, t4, global_ns()};
    for (int i = 0; i < 6; ++i) g_stamps[blin][i] = t[i];
  }
  if (!kPush) cluster_wait();
}

__device__ __forceinline__ void mbar_arrive_remote(uint32_t local_bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local_bar), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait_cluster(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ uint32_t pick4(const uint32_t* w, int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

__global__ void __launch_bounds__(kRqThreads, 1)
    persistent_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, int k_steps, GeluFinish fin,
                      int8_t* __restrict__ q, float* __restrict__ qs, int row_tiles) {
  constexpr int S = kRqStages, G = kRqColGroups;
  constexpr int kATile = 64 * 128, kBBox = 128 * 128, kStage = kATile + G * kBBox;
  __shared__ __align__(16) float col_scale[kRqCols];
  __shared__ __align__(16) float col_bias[kRqCols];
  __shared__ float group_max[G][64];
  __shared__ float row_max[2][kRqMaxCluster][64];
  __shared__ __align__(8) uint64_t bars[2 * S + 2];  // full[s], empty[s], maxima[2]
  extern __shared__ uint8_t gemm_smem[];
  const int tid = threadIdx.x, group = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kRqCols;
  const uint32_t rank = cluster_rank(), blocks = cluster_blocks();
  const uint32_t ring = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[S]);
  const uint32_t max0 = smem_u32(&bars[2 * S]);
  if (tid < kRqCols / 4) {
    reinterpret_cast<float4*>(col_scale)[tid] = reinterpret_cast<const float4*>(fin.col_scale + n0)[tid];
    reinterpret_cast<float4*>(col_bias)[tid] = reinterpret_cast<const float4*>(fin.bias + n0)[tid];
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * G);
    }
    mbar_init(max0, 32 * blocks);  // 32 pushing threads of every block
    mbar_init(max0 + 8, 32 * blocks);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // every block started, its barriers initialized
  cluster_wait();
  if (group == G) {  // the producer: every k step of every tile of this cluster
    if (lane == 0) {
      int g = 0;
      for (int t = blockIdx.y; t < row_tiles; t += gridDim.y) {
        for (int kt = 0; kt < k_steps; ++kt, ++g) {
          const int s = g % S;
          mbar_wait(empty0 + 8 * s, ((g / S) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s, a = ring + s * kStage;
          mbar_arrive_expect_tx(full, kStage);
          tma_load_2d(a, &map_a, full, kt * 128, t * 64);
          for (int c = 0; c < G; ++c) {
            tma_load_2d(a + kATile + c * kBBox, &map_b, full, kt * 128, n0 + c * 128);
          }
        }
      }
    }
    return;
  }
  const int lr = 16 * w + lane / 4, lc = group * 128 + 2 * (lane % 4), l4 = lane % 4;
  int g = 0, it = 0;
  for (int t = blockIdx.y; t < row_tiles; t += gridDim.y, ++it) {
    const int m0 = t * 64;
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    fence_acc(d);
    for (int kt = 0; kt < k_steps; ++kt, ++g) {
      const int s = g % S;
      mbar_wait(full0 + 8 * s, (g / S) & 1);
      const uint32_t a = ring + s * kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_s8(d, wgmma_desc(a + kk * 32), wgmma_desc(a + kATile + group * kBBox + kk * 32));
      }
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();
        mbar_arrive(empty0 + 8 * ((g - 1) % S));
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive(empty0 + 8 * ((g - 1) % S));
    float amax[2] = {0.f, 0.f}, rs[2];
    for (int h = 0; h < 2; ++h) rs[h] = m0 + lr + 8 * h < fin.m ? fin.row_scale[m0 + lr + 8 * h] : 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
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
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
      if (l4 == 0) group_max[group][lr + 8 * h] = amax[h];
    }
    rowquant_consumers_sync();
    const int buf = it & 1;  // a block is at most one tile ahead of its peers' reads
    if (group == 0 && l4 == 0) {
      float a[2];
      for (int h = 0; h < 2; ++h) {
        a[h] = group_max[0][lr + 8 * h];
        for (int gg = 1; gg < G; ++gg) a[h] = fmaxf(a[h], group_max[gg][lr + 8 * h]);
      }
      for (uint32_t b = 0; b < blocks; ++b) {
        st_cluster_f32(&row_max[buf][rank][lr], b, a[0]);
        st_cluster_f32(&row_max[buf][rank][lr + 8], b, a[1]);
        mbar_arrive_remote(max0 + 8 * buf, b);
      }
    }
    mbar_wait_cluster(max0 + 8 * buf, (it >> 1) & 1);
    uint32_t word[16];  // slice i: row lr's pair in the low half, row lr + 8's in the high
    float s[2];
    for (int h = 0; h < 2; ++h) {
      float a = row_max[buf][0][lr + 8 * h];
      for (uint32_t b = 1; b < blocks; ++b) a = fmaxf(a, row_max[buf][b][lr + 8 * h]);
      s[h] = __fdiv_rn(fmaxf(a, 1e-12f), 127.f);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t pr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t x0 = (uint8_t)(int8_t)__float2int_rn(__fdiv_rn(__int_as_float(d[4 * i + 2 * h]), s[h]));
        const uint32_t x1 = (uint8_t)(int8_t)__float2int_rn(__fdiv_rn(__int_as_float(d[4 * i + 2 * h + 1]), s[h]));
        pr[h] = x0 | (x1 << 8);
      }
      word[i] = pr[0] | (pr[1] << 16);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // lane j of a quad gathers slice 4p + j of the four lanes
      uint32_t got[4], tr[4];
      got[0] = pick4(word + 4 * p, l4);
#pragma unroll
      for (int r = 1; r < 4; ++r) got[r] = __shfl_xor_sync(0xffffffffu, pick4(word + 4 * p, l4 ^ r), r);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) tr[kq] = pick4(got, kq ^ l4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + lr + 8 * h;
        if (r < fin.m) {
          const uint32_t lo = ((tr[0] >> (16 * h)) & 0xffffu) | (((tr[1] >> (16 * h)) & 0xffffu) << 16);
          const uint32_t hi = ((tr[2] >> (16 * h)) & 0xffffu) | (((tr[3] >> (16 * h)) & 0xffffu) << 16);
          *reinterpret_cast<uint2*>(q + (size_t)r * fin.n + n0 + group * 128 + 8 * (4 * p + l4)) =
              make_uint2(lo, hi);
        }
      }
    }
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + lr + 8 * h;
      if (rank == 0 && group == 0 && l4 == 0 && r < fin.m) qs[r] = s[h];
    }
  }
}

struct Case {
  int m, n, k;
  int8_t *a, *bt, *q;
  float *rs, *cs, *bias, *qs, *g;
  std::vector<int8_t> ref_q;
  std::vector<float> ref_s;
};

// ms per launch over 20 launches after 3 warm ones (CUDA events)
template <typename F>
float time_ms(F launch) {
  for (int i = 0; i < 3; ++i) launch();
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaEventRecord(t0);
  for (int i = 0; i < 20; ++i) launch();
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  return ms / 20;
}

bool same_as_production(const Case& c) {
  std::vector<int8_t> hq((size_t)c.m * c.n);
  std::vector<float> hs(c.m);
  cudaMemcpy(hq.data(), c.q, hq.size(), cudaMemcpyDeviceToHost);
  cudaMemcpy(hs.data(), c.qs, hs.size() * 4, cudaMemcpyDeviceToHost);
  return hq == c.ref_q && hs == c.ref_s;
}

cudaLaunchConfig_t cluster_config(int cluster, int row_tiles, int threads, int smem,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, row_tiles);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kG, int kStages, int kPush, int kStaged, int kSmemCols>
void run_variant(const char* name, Case& c) {
  if (c.n % (128 * kG) || c.n / (128 * kG) > kRqMaxCluster) return;
  auto kernel = variant_kernel<kG, kStages, kPush, kStaged, kSmemCols>;
  const int smem = kStages * (64 + 128 * kG) * 128 + 1024;
  CUtensorMap ma, mb;
  encode_operand(&ma, c.a, c.m, c.k, 64);
  encode_operand(&mb, c.bt, c.n, c.k, 128);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(c.n / (128 * kG), (c.m + 63) / 64, 128 * kG + 32, smem, &attr);
  int clusters = 0;
  cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  const int steps = (c.k + 127) / 128;
  cudaMemset(c.q, 0, (size_t)c.m * c.n);
  auto launch = [&]() { return cudaLaunchKernelEx(&cfg, kernel, ma, mb, steps, GeluFinish{c.rs, c.cs, c.bias, c.m, c.n}, c.q, c.qs); };
  if (launch() != cudaSuccess || cudaDeviceSynchronize() != cudaSuccess) {
    printf("%s: launch failed: %s\n", name, cudaGetErrorString(cudaGetLastError()));
    return;
  }
  const bool same = same_as_production(c);
  const float ms = time_ms(launch);
  static long long st[1 << 13][6];
  cudaMemcpyFromSymbol(st, g_stamps, sizeof(st));
  const int nb = std::min(1 << 13, (int)(cfg.gridDim.x * cfg.gridDim.y));
  double us[5] = {0, 0, 0, 0, 0};
  for (int b = 0; b < nb; ++b) {
    for (int i = 0; i < 5; ++i) us[i] += (st[b][i + 1] - st[b][i]) * 1e-3 / nb;
  }
  printf("%-64s m %5d n %4d: %.4f ms, bit for bit %s, %d clusters of %d at once; per block "
         "(us): products %.2f, finish %.2f, exchange %.2f, quantize %.2f, stores %.2f\n",
         name, c.m, c.n, ms, same ? "yes" : "NO", clusters, c.n / (128 * kG), us[0], us[1],
         us[2], us[3], us[4]);
}

void run_persistent(Case& c) {
  RowquantGemmPlan p;
  rowquant_gemm_plan(c.m, c.n, c.k, &p);
  CUtensorMap ma, mb;
  encode_operand(&ma, c.a, c.m, c.k, 64);
  encode_operand(&mb, c.bt, c.n, c.k, 128);
  cudaFuncSetAttribute(persistent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(p.cluster, p.grid_y, p.threads, p.smem, &attr);
  int clusters = 0;
  cudaOccupancyMaxActiveClusters(&clusters, persistent_kernel, &cfg);
  cfg.gridDim.y = std::min(p.grid_y, clusters);
  const GeluFinish fin{c.rs, c.cs, c.bias, c.m, c.n};
  auto launch = [&]() {
    return cudaLaunchKernelEx(&cfg, persistent_kernel, ma, mb, (c.k + 127) / 128, fin, c.q, c.qs,
                              p.grid_y);
  };
  cudaMemset(c.q, 0, (size_t)c.m * c.n);
  if (launch() != cudaSuccess || cudaDeviceSynchronize() != cudaSuccess) {
    printf("persistent: launch failed: %s\n", cudaGetErrorString(cudaGetLastError()));
    return;
  }
  const bool same = same_as_production(c);
  printf("%-64s m %5d n %4d: %.4f ms, bit for bit %s, %d clusters\n",
         "persistent clusters, mbarrier exchange, 8-byte stores", c.m, c.n, time_ms(launch),
         same ? "yes" : "NO", clusters);
}

}  // namespace

int main() {
  const int shapes[2][3] = {{32896, 4096, 1024}, {12800, 3072, 768}};
  for (const auto& sh : shapes) {
    Case c;
    c.m = sh[0];
    c.n = sh[1];
    c.k = sh[2];
    std::vector<int8_t> ha((size_t)c.m * c.k), hb((size_t)c.n * c.k);
    std::vector<float> hrs(c.m), hcs(c.n), hbias(c.n);
    unsigned x = 12345;
    auto rnd = [&]() { return (x = x * 1664525u + 1013904223u) >> 8; };
    for (auto& v : ha) v = (int8_t)(rnd() % 255 - 127);
    for (auto& v : hb) v = (int8_t)(rnd() % 255 - 127);
    for (auto& v : hrs) v = 0.02f * (rnd() % 1000) / 1000.f + 1e-3f;
    for (auto& v : hcs) v = (0.02f * (rnd() % 1000) / 1000.f + 1e-3f) / sqrtf((float)c.k);
    for (auto& v : hbias) v = 0.02f * ((int)(rnd() % 2001) - 1000) / 1000.f;
    cudaMalloc(&c.a, ha.size());
    cudaMalloc(&c.bt, hb.size());
    cudaMalloc(&c.q, (size_t)c.m * c.n);
    cudaMalloc(&c.g, (size_t)c.m * c.n * 4);
    cudaMalloc(&c.rs, c.m * 4);
    cudaMalloc(&c.qs, c.m * 4);
    cudaMalloc(&c.cs, c.n * 4);
    cudaMalloc(&c.bias, c.n * 4);
    cudaMemcpy(c.a, ha.data(), ha.size(), cudaMemcpyHostToDevice);
    cudaMemcpy(c.bt, hb.data(), hb.size(), cudaMemcpyHostToDevice);
    cudaMemcpy(c.rs, hrs.data(), c.m * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(c.cs, hcs.data(), c.n * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(c.bias, hbias.data(), c.n * 4, cudaMemcpyHostToDevice);
    const GeluFinish fin{c.rs, c.cs, c.bias, c.m, c.n};
    const int rc = launch_gemm_s8_rowquant(c.a, c.bt, c.k, fin, c.q, c.qs, 0);
    if (rc != 0 || cudaDeviceSynchronize() != cudaSuccess) {
      printf("the production launch failed: %d\n", rc);
      return 1;
    }
    c.ref_q.resize((size_t)c.m * c.n);
    c.ref_s.resize(c.m);
    cudaMemcpy(c.ref_q.data(), c.q, c.ref_q.size(), cudaMemcpyDeviceToHost);
    cudaMemcpy(c.ref_s.data(), c.qs, c.m * 4, cudaMemcpyDeviceToHost);
    const int m = c.m, n = c.n, k = c.k;
    printf("%-64s m %5d n %4d: %.4f ms\n", "production (gemm_wgmma_s8_rowquant_kernel)", m, n,
           time_ms([&]() { launch_gemm_s8_rowquant(c.a, c.bt, k, fin, c.q, c.qs, 0); }));
    printf("%-64s m %5d n %4d: %.4f ms\n", "the two launches it replaces (fc1 f32, rowquant)", m,
           n, time_ms([&]() {
             launch_gemm_s8<float, kGelu>(c.a, c.bt, c.rs, c.cs, c.bias, nullptr, c.g, m, n, k, 0);
             launch_ln_rowquant<float, false>(c.g, nullptr, nullptr, c.q, c.qs, m, n, 0);
           }));
    printf("%-64s m %5d n %4d: %.4f ms\n", "  fc1 writing f32 alone", m, n, time_ms([&]() {
             launch_gemm_s8<float, kGelu>(c.a, c.bt, c.rs, c.cs, c.bias, nullptr, c.g, m, n, k, 0);
           }));
    printf("%-64s m %5d n %4d: %.4f ms\n", "  rowquant of the f32 rows alone", m, n,
           time_ms([&]() { launch_ln_rowquant<float, false>(c.g, nullptr, nullptr, c.q, c.qs, m, n, 0); }));
    // G, stages, push, staged stores, columns in shared memory
    run_variant<4, 3, 0, 0, 0>("64x512, 3 stages: pull, 2-byte stores, columns from L1", c);
    run_variant<4, 3, 1, 0, 0>("64x512, 3 stages: push, 2-byte stores, columns from L1", c);
    run_variant<4, 3, 1, 1, 0>("64x512, 3 stages: push, staged stores, columns from L1", c);
    run_variant<4, 3, 1, 1, 1>("64x512, 3 stages: push, staged stores, columns in smem", c);
    run_variant<4, 2, 1, 1, 1>("64x512, 2 stages: push, staged stores, columns in smem", c);
    run_variant<3, 3, 1, 1, 1>("64x384, 3 stages: push, staged stores, columns in smem", c);
    run_persistent(c);
    cudaFree(c.a);
    cudaFree(c.bt);
    cudaFree(c.q);
    cudaFree(c.g);
    cudaFree(c.rs);
    cudaFree(c.qs);
    cudaFree(c.cs);
    cudaFree(c.bias);
  }
  return 0;
}
