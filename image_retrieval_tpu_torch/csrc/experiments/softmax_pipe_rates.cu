// The issue cost of each instruction kind the bf16 attention's softmax
// (csrc/attention_sm90.cuh) is made of, on the card: a standalone program,
// not part of the library. Built and run by attention_variants.py beside it.
//
// One block an SM of 256 threads (the attention's eight warps, two on each
// SM sub-partition); each thread runs kChains independent chains (16, and
// for one kind up to the attention's 144) of one kind of operation for
// `kIters` rounds; thread 0 of each block reads clock64 around
// the loop. Printed: SM cycles per warp instruction on one sub-partition
// (cycles / (rounds x chains x warps there)), so 1.0 is one warp instruction a
// cycle, and the same for a whole softmax element of each step (the
// attention's pass 1, 2 and 3 for one score).
#include <cuda_runtime.h>
#include <math.h>
#include <stdio.h>

constexpr int kIters = 4096, kThreads = 256;  // at most: the attention's eight warps

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a / b correctly rounded for the softmax's range (attention_mma.cuh's)
__device__ __forceinline__ float div_rn_by(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

template <int kOp, int kChains>
__global__ void __launch_bounds__(kThreads, 1) rate_kernel(float* out, long long* cycles) {
  float v[kChains], m = -INFINITY, s = 0.f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) v[k] = 1e-3f * (threadIdx.x + k) - 1.f;
  const float b = 1.5f + 1e-3f * threadIdx.x, y = __frcp_rn(b);
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < kIters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (kOp == 0) v[k] = __fmaf_rn(v[k], 0.999f, 1e-3f);  // FFMA
      if (kOp == 1) v[k] = fmaxf(v[k], v[(k + 5) % kChains] - 1e-3f);  // FMNMX (+ FADD)
      if (kOp == 2) v[k] = ex2(v[k]) - 1.f;  // MUFU.EX2 (+ FADD)
      if (kOp == 3) v[k] = expf(v[k]) - 1.f;  // expf (+ FADD)
      if (kOp == 4) v[k] = div_rn_by(v[k] * 0.5f + 0.5f, b, y);  // the quotient (+ FFMA)
      if (kOp == 5) {  // one element of pass 1: scale, min, mask, max
        const float u = __fmul_rn(v[k], 0.125f);
        s = fminf(s, u);
        v[k] = (threadIdx.x + k * 7 + i) % 64 > 60 ? -INFINITY : u + 1e-3f;
        m = fmaxf(m, v[k]);
      }
      if (kOp == 6) {  // one element of pass 2: exp of the difference, the sum
        v[k] = expf(__fsub_rn(v[k], 0.25f));
        s += v[k];
        v[k] -= 0.5f;
      }
    }
    if (kOp == 7) {  // the attention's three passes in turn over the thread's scores
      float mx = -INFINITY, mn = INFINITY, sum = 0.f;
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        v[k] = __fmul_rn(v[k], 0.125f);
        mn = fminf(mn, v[k]);
        v[k] = k * 8 + (threadIdx.x & 3) > 200 + (i & 63) ? -INFINITY : v[k];
        mx = fmaxf(mx, v[k]);
      }
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        v[k] = expf(__fsub_rn(v[k], mx));
        sum += v[k];
      }
      const float inv = __frcp_rn(sum);
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        v[k] = div_rn_by(v[k], sum, inv) * 64.f - 1.f + mn * 1e-9f;
      }
    }
  }
  const long long t1 = clock64();
  float acc = m + s;
#pragma unroll
  for (int k = 0; k < kChains; ++k) acc += v[k];
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int kOp, int kChains = 16, int kWarps = 8>
double run(const char* what, float* out, long long* cycles, int blocks) {
  rate_kernel<kOp, kChains><<<blocks, 32 * kWarps>>>(out, cycles);
  rate_kernel<kOp, kChains><<<blocks, 32 * kWarps>>>(out, cycles);
  if (cudaDeviceSynchronize() != cudaSuccess) {
    printf("NO %s failed\n", what);
    return 0;
  }
  long long host[1024];
  cudaMemcpy(host, cycles, blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  long long mx = 0;
  for (int i = 0; i < blocks; ++i) mx = host[i] > mx ? host[i] : mx;
  // warp instructions of the kind on one sub-partition: kWarps / 4 warps there
  const double per = (double)mx / ((double)kIters * kChains * (kWarps / 4));
  printf("%s, %d chains a thread, %d warps an SM: %.3f SM cycles per warp item on one "
         "sub-partition\n", what, kChains, kWarps, per);
  return per;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  long long* cycles;
  cudaMalloc(&out, (size_t)sms * kThreads * sizeof(float));
  cudaMalloc(&cycles, (size_t)sms * sizeof(long long));
  run<0>("FFMA", out, cycles, sms);
  run<1>("FMNMX + FADD", out, cycles, sms);
  run<2>("MUFU.EX2 + FADD", out, cycles, sms);
  run<3>("expf + FADD", out, cycles, sms);
  run<4>("div_rn_by + FFMA", out, cycles, sms);
  run<5>("pass 1 element (scale, min, mask, max)", out, cycles, sms);
  run<6>("pass 2 element (expf of the difference, sum)", out, cycles, sms);
  // the same work unrolled over more scores a thread: code and registers
  // grow as in the attention's 144 scores a thread
  run<6, 48>("pass 2 element (expf of the difference, sum)", out, cycles, sms);
  run<6, 96>("pass 2 element (expf of the difference, sum)", out, cycles, sms);
  run<6, 144>("pass 2 element (expf of the difference, sum)", out, cycles, sms);
  // one element of all three passes (one loop each over the thread's
  // scores, as in the attention), at 16, 48 and 144 scores a thread
  run<7, 16>("three passes' element", out, cycles, sms);
  run<7, 48>("three passes' element", out, cycles, sms);
  run<7, 144>("three passes' element", out, cycles, sms);
  // one warp a sub-partition: what one warp issues alone
  run<0, 16, 4>("FFMA", out, cycles, sms);
  run<6, 144, 4>("pass 2 element (expf of the difference, sum)", out, cycles, sms);
  run<7, 144, 4>("three passes' element", out, cycles, sms);
  cudaFree(out);
  cudaFree(cycles);
  return 0;
}
