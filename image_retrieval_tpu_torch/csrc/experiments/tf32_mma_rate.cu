// Instruction rates behind the f32 metric sweep (f32_sweep_sm90.cuh): how
// many mma.sync m16n8k8 tf32 (the sweep's product), mma.sync m16n8k16 bf16
// (K5's) and f32 FMAs one card completes, with 1 to 8 independent chains a
// warp and 8 or 4 warps a block, one block an SM. Not part of the library: a
// standalone program.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o rates tf32_mma_rate.cu && ./rates
//
// (`python3 image_retrieval_tpu_torch/csrc/experiments/f32_sweep_variants.py`
// builds and runs it first.) Each line:
// the instruction, chains, warps a block, TFLOP/s (an mma's or FMA's
// multiply-adds counted twice) and SM-sub-partition clocks an instruction
// (at the clock the card reports).
#include <cstdio>

#include "../f32_sweep_sm90.cuh"

namespace {

template <int kChains>
__global__ void tf32_rate(float* out, int iters) {
  float c[kChains][4] = {};
  const uint32_t a[4] = {tf32_rna(1.0f + threadIdx.x * 1e-3f), tf32_rna(0.5f), tf32_rna(0.25f),
                         tf32_rna(0.125f)};
  const uint32_t b0 = tf32_rna(1e-3f), b1 = tf32_rna(2e-3f);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) mma_tf32(c[k], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kChains>
__global__ void bf16_rate(float* out, int iters) {
  float c[kChains][4] = {};
  const unsigned a[4] = {0x3F803F80u + threadIdx.x, 0x3F003F00u, 0x3E803E80u, 0x3E003E00u};
  const unsigned b[2] = {0x3A833A83u, 0x3B033B03u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) mma_bf16(c[k], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kChains>
__global__ void ffma_rate(float* out, int iters) {
  float c[kChains];
  const float x = 1.0f + threadIdx.x * 1e-7f, y = 0.999999f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) c[k] = k * 1e-3f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) c[k] = fmaf(c[k], y, x);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += c[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename Kernel>
void time_one(const char* what, Kernel kernel, int chains, int warps, double flops_each, int sms,
              double ghz, float* out) {
  const int iters = 4096;
  kernel<<<sms, 32 * warps>>>(out, iters);  // warm
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  const int reps = 5;
  for (int r = 0; r < reps; ++r) kernel<<<sms, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  ms /= reps;
  const double instrs = (double)sms * warps * iters * chains;  // warp instructions
  const double tflops = instrs * flops_each / (ms * 1e-3) / 1e12;
  // SM-sub-partition clocks per warp instruction: each SM has 4
  const double clocks = (ms * 1e-3) * ghz * 1e9 * 4 / (instrs / sms);
  printf("%s chains %d warps %d: %.1f TFLOP/s, %.2f clocks an instruction per sub-partition\n",
         what, chains, warps, tflops, clocks);
  if (cudaGetLastError() != cudaSuccess) printf("NO launch failed\n");
}

}  // namespace

int main() {
  int dev = 0, sms = 0, khz = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  const double ghz = khz * 1e-6;
  float* out = nullptr;
  cudaMalloc(&out, (size_t)sms * 1024 * sizeof(float));
  printf("%d SMs, clock %.3f GHz (the attribute; a loaded card may run lower)\n", sms, ghz);
  const double tf32_flops = 2.0 * 16 * 8 * 8, bf16_flops = 2.0 * 16 * 8 * 16, fma_flops = 64.0;
  for (int warps : {8, 4}) {
    time_one("mma.sync m16n8k8 tf32", tf32_rate<1>, 1, warps, tf32_flops, sms, ghz, out);
    time_one("mma.sync m16n8k8 tf32", tf32_rate<2>, 2, warps, tf32_flops, sms, ghz, out);
    time_one("mma.sync m16n8k8 tf32", tf32_rate<4>, 4, warps, tf32_flops, sms, ghz, out);
    time_one("mma.sync m16n8k8 tf32", tf32_rate<8>, 8, warps, tf32_flops, sms, ghz, out);
    time_one("mma.sync m16n8k16 bf16", bf16_rate<4>, 4, warps, bf16_flops, sms, ghz, out);
    time_one("mma.sync m16n8k16 bf16", bf16_rate<8>, 8, warps, bf16_flops, sms, ghz, out);
    time_one("f32 fma", ffma_rate<8>, 8, warps, fma_flops, sms, ghz, out);
  }
  cudaFree(out);
  return 0;
}
