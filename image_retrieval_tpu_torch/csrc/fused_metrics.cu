// Hopper (sm_90a) fused metric kernels over a (unit row, magnitude) gallery.
//
// They replace the TPU kernels of image_retrieval_tpu/ops/pallas_kernels.py:
//   K6  _fused_kernel (l.45)  under fused_all_metrics (l.78): the five metric
//       planes (cosine, L1/d, direct L2/sqrt(d), Linf, |dmag|) in one read;
//   K7  _combo_kernel (l.124) under fused_optimized_scores (l.541): the
//       weighted score with weights read at run time, Gram-form L2;
//   K5  _make_int8_combo_kernel (l.162) and _make_int8_combo_kernel_v2
//       (l.275) under fused_optimized_scores_int8_pallas (l.234) and
//       ..._pallas_v2 (l.349): the weighted score over int8 rows. The two
//       bodies have one contract and differ in how they schedule the TPU's
//       vector unit, so one kernel here serves both;
//   K4  _make_combo_topk_kernel (l.399) under fused_optimized_topk (l.480):
//       the weighted score and the top-k selection in one kernel, so that the
//       (Q, N) score plane never reaches device memory.
// Each computes its own row x query products; no library call takes part.
//
// What bounds them on this card. At Q = 1 the read of the rows (2 KB per
// f32 row at D = 512, 768 B per int8 row at D = 768). From a few queries on,
// K4, K6 and K7 take the product on the tensor cores (three TF32 products a
// value, f32_sweep_sm90.cuh) and are then bound by the f32 differences where
// L1/Linf (or K6's direct L2) are live: per (query, row, dim) a subtract, an
// add, a max (and an FMA) on the CUDA cores, against 33.5 T such operations
// a second; the planes K6 writes (20 B per query and row) stay under that.
// K5 has its own sweep (int8_sweep_sm90.cuh, which says what bounds it).
//
// K4, K6 and K7 run one sweep (f32_sweep_sm90.cuh, which sets out its
// design): persistent blocks stream the rows once per pass of resident
// queries through a TMA ring; 16-row units of 8 or 32 queries a warp; the
// products on mma.sync in split TF32 (hi*lo + lo*hi + hi*hi), their sums
// restarted every box into f32 totals (K4 with the Gram-form L2 live: on the
// CUDA cores, in the order of the sweep this one replaced); the differences
// in f32 on the CUDA cores in the plain version's roundings; weights whose
// bit in `live` is clear choose an instantiation without the product, the
// L1 sum or the Linf max, so a dead term costs nothing. K6 writes its five planes and K7 its
// score plane from the units' fragments; K4 merges each unit's scores into
// the warp's own top-kk lists while the other warps sweep, best first,
// lowest row first among equal scores. A NaN score counts as -inf, and a row
// whose score is -inf is still a candidate under its own row number: only
// columns past N are never returned.
// K5 rounds where the int8 scorer rounds: the query and the reconstruction
// bf16(int8 * bf16(scale*mag)) once each, the difference u - q once more
// (one bf16 fma: the exact difference rounded once; the plain version's
// f32 difference of two bf16 values is exact unless their exponents are more
// than 16 apart, and then rounding twice gives the larger value, as rounding
// once does), every product exact, the sums in f32. Its sweep streams the
// rows through a TMA ring once for all queries, takes the product and the
// L1 sum on the tensor cores and the differences in packed bf16
// (int8_sweep_sm90.cuh).

#include "fused_metrics.cuh"
#include "int8_sweep_sm90.cuh"
#include "f32_sweep_sm90.cuh"

#include <atomic>
#include <string.h>

namespace {

using namespace fm;

// Which sums the live weights need, as the case of IRT_LIVE_CASES: bit 0
// the product (cosine or the Gram-form L2), bit 1 the L1 sum, bit 2 the
// Linf max.
int live_case(const Weights& w) {
  return ((w.live & (1 | 4)) ? 1 : 0) | ((w.live & 2) ? 2 : 0) | ((w.live & 8) ? 4 : 0);
}

// One launch per case of live_case: IRT_LAUNCH(dot, l1, linf).
#define IRT_LIVE_CASE(c)                                        \
  case c:                                                       \
    IRT_LAUNCH(((c) & 1) != 0, ((c) & 2) != 0, ((c) & 4) != 0); \
    break;
#define IRT_LIVE_CASES(code)                                                        \
  switch (code) {                                                                   \
    IRT_LIVE_CASE(0) IRT_LIVE_CASE(1) IRT_LIVE_CASE(2) IRT_LIVE_CASE(3)             \
    IRT_LIVE_CASE(4) IRT_LIVE_CASE(5) IRT_LIVE_CASE(6) IRT_LIVE_CASE(7)             \
  }

Weights make_weights(float w0, float w1, float w2, float w3, float w4, int live) {
  Weights w;
  w.w[0] = w0;
  w.w[1] = w1;
  w.w[2] = w2;
  w.w[3] = w3;
  w.w[4] = w4;
  w.live = live & 31;
  return w;
}

// K5: the weighted score over int8 rows in the int8 scorer's arithmetic, on
// the sweep of int8_sweep_sm90.cuh. Block b walks tiles b, b + grid, ...;
// per tile and pass, warp w takes row unit w % (8 / groups) and query group
// w / (8 / groups). The producer warp and the consumers walk the same
// sequence of (tile, pass, box) stages.
template <bool kDot, bool kL1, bool kLinf, int kQW>
__global__ void __launch_bounds__(kSwThreads, 1) optimized_scores_int8_kernel(
    const __grid_constant__ CUtensorMap map, const int8_t* __restrict__ rows,
    const float* __restrict__ q, const float* __restrict__ qn, const float* __restrict__ scales,
    const float* __restrict__ mags, float* __restrict__ out, int nq, int n, int d, Weights w,
    Int8SweepPlan p) {
  constexpr bool kSweep = kDot || kL1 || kLinf;
  constexpr int kNG = kQW / 8;
  extern __shared__ __align__(16) uint8_t sweep_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kSwMaxStages];  // full[s], then empty[s]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t base = smem_u32(sweep_smem);
  const uint32_t ring = (base + kSwAlign - 1) & ~(uint32_t)(kSwAlign - 1);
  uint8_t* const ring_ptr = sweep_smem + (ring - base);
  __nv_bfloat16* const sq =
      reinterpret_cast<__nv_bfloat16*>(ring_ptr + (size_t)p.stages * p.stage_bytes);
  float* const s_qn = reinterpret_cast<float*>(sq + (size_t)p.q_rows * p.q_pitch);
  constexpr int kPitch = kQW + 1, kPlane = kSwUnitRows * kPitch;
  float* const scratch = s_qn + p.q_rows + warp * kPlane * sweep_planes(kQW);
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[kSwMaxStages]);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, p.tma ? 1 : 32);  // the expect-tx arrival, or every copying lane
      mbar_init(empty0 + 8 * s, kSwWarps);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kSwWarps) {  // the producer
    if constexpr (kSweep) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int pass = 0; pass < p.passes; ++pass) {
          for (int b = 0; b < p.boxes; ++b, ++it) {
            const int s = it % p.stages;
            const uint32_t full = full0 + 8 * s, empty = empty0 + 8 * s;
            // the stage's previous use released; parity 1 passes at once on
            // the first round
            const uint32_t parity = ((it / p.stages) & 1) ^ 1;
            if (p.tma) {
              if (lane == 0) {
                mbar_wait(empty, parity);
                mbar_arrive_expect_tx(full, p.stage_bytes);
                tma_load_2d(ring + s * p.stage_bytes, &map, full, b * kSwBoxDims,
                            tile * p.tile_rows);
              }
            } else {
              mbar_wait(empty, parity);
              copy_box(ring_ptr + (size_t)s * p.stage_bytes, rows, n, d, tile * p.tile_rows,
                       p.tile_rows, b, lane);
              mbar_arrive(full);
            }
          }
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int units = kSwWarps / p.groups;
  const int ru = warp % units, grp = warp / units;
  const int pass_q = p.groups * kQW;
  uint32_t sel[4][2];  // the L1 mma's B operand for query pair pp (columns 2 pp, 2 pp + 1)
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    sel[pp][0] = g == 2 * pp ? kBf16One2 : 0u;
    sel[pp][1] = g == 2 * pp + 1 ? kBf16One2 : 0u;
  }
  if (p.resident) {
    load_query_rows(sq, s_qn, q, qn, 0, p.q_rows, nq, d, p.boxes, p.q_pitch);
    consumers_sync();
  }
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int row0 = tile * p.tile_rows + kSwUnitRows * ru;  // the unit's first row
    // lane l's row row0 + l: its magnitude and scale, and bf16(scale * mag)
    const float mrow = row0 + lane < n ? mags[row0 + lane] : 0.f;
    const float srow = row0 + lane < n ? scales[row0 + lane] : 0.f;
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(srow, mrow)));
    uint32_t rs2[4];  // bf16(scale * mag) of rows row0 + g + 8 i, in both halves
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t hi = __shfl_sync(0xffffffffu, h, g + 8 * i);
      rs2[i] = hi | (hi << 16);
    }
    for (int pass = 0; pass < p.passes; ++pass) {
      const int qg = pass * pass_q + grp * kQW;  // the unit's first query
      int qs = qg;                               // its row in shared memory
      if (!p.resident) {
        consumers_sync();  // every warp is done with the last pass's queries
        load_query_rows(sq, s_qn, q, qn, pass * pass_q, pass_q, nq, d, p.boxes, p.q_pitch);
        consumers_sync();
        qs = grp * kQW;
      }
      const bool active = qg < nq && row0 < n;  // the same for the whole warp
      const int live_q = nq - qg;                // queries of the unit: those below kQW
      SweepAcc<kQW> acc;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc.l1[m][k] = 0.f;
#pragma unroll
          for (int nn = 0; nn < kNG; ++nn) acc.dot[m][nn][k] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc.lin[i][j] = 0u;
      }
      if constexpr (kSweep) {
        for (int b = 0; b < p.boxes; ++b, ++it) {
          const int s = it % p.stages;
          mbar_wait(full0 + 8 * s, (it / p.stages) & 1);
          if (active) {
            const uint8_t* unit =
                ring_ptr + (size_t)s * p.stage_bytes + kSwUnitRows * ru * kSwBoxDims;
            const __nv_bfloat16* qbox = sq + (size_t)qs * p.q_pitch + b * kSwBoxDims;
            if constexpr (kL1 || kLinf) {
              if (live_q >= kQW) {
                sweep_box_diff<kDot, kL1, kLinf, true>(unit, qbox, p.q_pitch, live_q, g, t, rs2,
                                                       sel, acc);
              } else {
                sweep_box_diff<kDot, kL1, kLinf, false>(unit, qbox, p.q_pitch, live_q, g, t, rs2,
                                                        sel, acc);
              }
            } else if (live_q >= kQW) {
              sweep_box_dot<kQW, true>(unit, qbox, p.q_pitch, live_q, g, t, acc);
            } else {
              sweep_box_dot<kQW, false>(unit, qbox, p.q_pitch, live_q, g, t, acc);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
      }
      if (!active) continue;
      // the sums into the warp's scratch, [row][query] per plane: product,
      // L1, Linf
      float linf[4][2] = {};
      if constexpr (kLinf) linf_of_lane(acc.lin, t, linf);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* at = scratch + (g + 8 * i) * kPitch + 2 * t + c;
          const int k = (i & 1) * 2 + c;
#pragma unroll
          for (int nn = 0; nn < kNG; ++nn) at[8 * nn] = acc.dot[i >> 1][nn][k];
          if constexpr (kL1) at[kPlane] = acc.l1[i >> 1][k];
          if constexpr (kLinf) at[2 * kPlane] = linf[i][c];
        }
      }
      __syncwarp();
      // lane l scores row row0 + l against the unit's queries: 128
      // contiguous bytes of the (Q, N) plane a query
      if (row0 + lane < n) {
        const float* mine = scratch + lane * kPitch;
        const int count = live_q < kQW ? live_q : kQW;
#pragma unroll 2
        for (int j = 0; j < count; ++j) {
          const float l1 = kL1 ? mine[kPlane + j] : 0.f;
          const float lmax = kLinf ? mine[2 * kPlane + j] : 0.f;
          out[(size_t)(qg + j) * n + row0 + lane] =
              weighted<true>(w, __fmul_rn(mine[j], srow), l1, lmax, mrow, s_qn[qs + j], d);
        }
      }
      __syncwarp();  // the scratch is read before the next unit writes it
    }
  }
}

// K5's plan on the current device; false where int8_sweep_plan refuses.
bool k5_plan(int nq, int n, int d, int live, const void* rows, Int8SweepPlan* p) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return false;
  }
  return int8_sweep_plan(nq, n, d, live, (uintptr_t)rows % 16 == 0, sms, p);
}

template <bool kDot, bool kL1, bool kLinf, int kQW>
int launch_int8_sweep_as(const CUtensorMap& map, const void* q, const void* qn, const void* rows,
                         const void* scales, const void* mags, void* out, int nq, int n, int d,
                         const Weights& w, const Int8SweepPlan& p, cudaStream_t st) {
  auto kernel = optimized_scores_int8_kernel<kDot, kL1, kLinf, kQW>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  IRT_TRY(kernel<<<p.grid, kSwThreads, p.smem, st>>>(
      map, (const int8_t*)rows, (const float*)q, (const float*)qn, (const float*)scales,
      (const float*)mags, (float*)out, nq, n, d, w, p));
  return 0;
}

// The instantiation of the plan's unit width: 8 queries with L1 or Linf
// live, 32 or 16 with only the product, 16 with no sum at all.
template <bool kDot, bool kL1, bool kLinf>
int launch_int8_sweep(const CUtensorMap& map, const void* q, const void* qn, const void* rows,
                      const void* scales, const void* mags, void* out, int nq, int n, int d,
                      const Weights& w, const Int8SweepPlan& p, cudaStream_t st) {
  constexpr int kQW = (kL1 || kLinf) ? 8 : 16;
  if (kDot && !kL1 && !kLinf && p.qw == 32) {
    return launch_int8_sweep_as<true, false, false, 32>(map, q, qn, rows, scales, mags, out, nq,
                                                        n, d, w, p, st);
  }
  if (p.qw != kQW) return IRT_BAD_ARGS;
  return launch_int8_sweep_as<kDot, kL1, kLinf, kQW>(map, q, qn, rows, scales, mags, out, nq, n,
                                                     d, w, p, st);
}

}  // namespace


namespace {

constexpr int kMaxDevices = 64;

// The current device and its SMs, the count read once per device.
bool device_sms(int* dev, int* sms) {
  static std::atomic<int> known[kMaxDevices];
  if (cudaGetDevice(dev) != cudaSuccess || *dev < 0 || *dev >= kMaxDevices) return false;
  *sms = known[*dev].load(std::memory_order_relaxed);
  if (*sms == 0) {
    if (cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev) != cudaSuccess) {
      return false;
    }
    known[*dev].store(*sms, std::memory_order_relaxed);
  }
  return true;
}

// The f32 sweep's plan on the current device; false where f32_sweep_plan
// refuses.
bool fs_plan(int nq, int n, int d, int row_bytes, int live, int kk, const void* rows,
             F32SweepPlan* p) {
  int dev = 0, sms = 0;
  return device_sms(&dev, &sms) &&
         f32_sweep_plan(nq, n, d, row_bytes, live, kk, (uintptr_t)rows % 16 == 0, sms, p);
}

// One launch of the sweep under plan p (its tensor map encoded where it
// takes TMA). The caller passes the padded query copy exactly where the
// plan does not keep the queries resident: IRT_BAD_ARGS otherwise, as for a
// plan whose unit width is not the instantiation's. The instantiation's
// shared-memory limit is raised once per device, to what any plan takes.
template <int kKind, typename RowT, int kQW, int kDot, bool kL1, bool kLinf>
int launch_f32_sweep(const F32SweepArgs& a, const F32SweepPlan& p, cudaStream_t st) {
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0, sms = 0;
  if (p.qw != kQW || (p.resident != 0) != (a.qpad == nullptr) || !device_sms(&dev, &sms)) {
    return IRT_BAD_ARGS;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (p.tma && (kDot || kL1 || kLinf)) {
    if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
    if (!fs_encode(&map, a.rows, a.n, a.d, (int)sizeof(RowT), p)) return IRT_BAD_ARGS;
  }
  auto kernel = f32_sweep_kernel<kKind, RowT, kQW, kDot, kL1, kLinf>;
  if (!raised[dev].load(std::memory_order_relaxed)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSwSmemMax);
    if (e != cudaSuccess) return (int)e;
    raised[dev].store(true, std::memory_order_relaxed);
  }
  IRT_TRY(kernel<<<dim3(p.grid, p.passes), kSwThreads, p.smem, st>>>(map, a, p));
  return 0;
}

F32SweepArgs fs_args(const void* q, const void* qn, const void* qpad, const void* rows,
                     const void* mags, int nq, int n, int d) {
  F32SweepArgs a;
  memset(&a, 0, sizeof(a));
  a.q = (const float*)q;
  a.qn = (const float*)qn;
  a.qpad = (const float*)qpad;
  a.rows = rows;
  a.mags = (const float*)mags;
  a.nq = nq;
  a.n = n;
  a.d = d;
  return a;
}

// K4 over rows of RowT: the instantiation of the live sums and the plan's
// unit width (32 queries where only the cosine's product is live and they
// fit, else 8). With the Gram-form L2 live the product runs on the CUDA
// cores (kDot 2, f32_sweep_sm90.cuh says why).
template <typename RowT>
int launch_topk(const F32SweepArgs& a, const F32SweepPlan& p, cudaStream_t st) {
  const int c = live_case(a.w);
  if (c == 1 && p.qw == 32) {
    return launch_f32_sweep<kFsTopk, RowT, 32, 1, false, false>(a, p, st);
  }
  if (a.w.live & 4) {
    switch (c >> 1) {
      case 0:
        return launch_f32_sweep<kFsTopk, RowT, 8, 2, false, false>(a, p, st);
      case 1:
        return launch_f32_sweep<kFsTopk, RowT, 8, 2, true, false>(a, p, st);
      case 2:
        return launch_f32_sweep<kFsTopk, RowT, 8, 2, false, true>(a, p, st);
      default:
        return launch_f32_sweep<kFsTopk, RowT, 8, 2, true, true>(a, p, st);
    }
  }
#define IRT_LAUNCH(dot, l1, linf) return launch_f32_sweep<kFsTopk, RowT, 8, dot, l1, linf>(a, p, st)
  IRT_LIVE_CASES(c)
#undef IRT_LAUNCH
  return IRT_BAD_ARGS;
}

}  // namespace

extern "C" int irt_fused_all_metrics(const void* q, const void* qn, const void* qpad,
                                     const void* rows, const void* mags, void* out, int nq, int n,
                                     int d, void* stream) {
  F32SweepPlan p;
  if (!fs_plan(nq, n, d, 4, 31, 0, rows, &p)) return IRT_BAD_ARGS;
  F32SweepArgs a = fs_args(q, qn, qpad, rows, mags, nq, n, d);
  a.out = (float*)out;
  return launch_f32_sweep<kFsPlanes, float, 8, 1, true, true>(a, p, (cudaStream_t)stream);
}

extern "C" int irt_fused_optimized_scores(const void* q, const void* qn, const void* qpad,
                                          const void* weights, const void* rows, const void* mags,
                                          void* out, int nq, int n, int d, void* stream) {
  F32SweepPlan p;
  if (!fs_plan(nq, n, d, 4, 31, 0, rows, &p)) return IRT_BAD_ARGS;
  F32SweepArgs a = fs_args(q, qn, qpad, rows, mags, nq, n, d);
  a.out = (float*)out;
  a.wdev = (const float*)weights;
  return launch_f32_sweep<kFsScores, float, 8, 1, true, true>(a, p, (cudaStream_t)stream);
}

extern "C" int irt_fused_optimized_topk(const void* q, const void* qn, const void* qpad,
                                        const void* rows, int rows_bf16, const void* mags,
                                        void* out_v, void* out_i, int nq, int n, int d, int kk,
                                        int lists, float w0, float w1, float w2, float w3,
                                        float w4, int live, void* stream) {
  if (kk < 1 || kk > kMaxK || kk > n) return IRT_BAD_ARGS;
  F32SweepPlan p;
  F32SweepArgs a = fs_args(q, qn, qpad, rows, mags, nq, n, d);
  a.w = make_weights(w0, w1, w2, w3, w4, live);
  if (!fs_plan(nq, n, d, rows_bf16 ? 2 : 4, a.w.live, kk, rows, &p) || p.lists != lists) {
    return IRT_BAD_ARGS;  // the caller's candidate buffers hold `lists` lists
  }
  a.out = (float*)out_v;
  a.out_i = (int*)out_i;
  a.kk = kk;
  const cudaStream_t st = (cudaStream_t)stream;
  return rows_bf16 ? launch_topk<__nv_bfloat16>(a, p, st) : launch_topk<float>(a, p, st);
}

// The f32 sweep's launch plan as K4, K6 and K7 would take it: 0 and out[17]
// = (qw, groups, tile_rows, passes, resident, q_rows, q_pitch, box_dims,
// boxes, stage_boxes, stages, stage_bytes, tma, tiles, grid, lists, smem), or
// IRT_BAD_ARGS where the kernels refuse the shape. row_bytes 4 (f32) or 2
// (bf16); kk 0 for K6 and K7; `aligned`: the rows' base is 16-byte aligned.
extern "C" int irt_f32_sweep_plan(int nq, int n, int d, int row_bytes, int live, int kk,
                                  int aligned, int sms, int* out) {
  F32SweepPlan p;
  if (!f32_sweep_plan(nq, n, d, row_bytes, live & 31, kk, aligned != 0, sms, &p)) {
    return IRT_BAD_ARGS;
  }
  const int v[17] = {p.qw,     p.groups,      p.tile_rows, p.passes, p.resident, p.q_rows,
                     p.q_pitch, p.box_dims,  p.boxes,     p.stage_boxes, p.stages, p.stage_bytes,
                     p.tma,    p.tiles,       p.grid,      p.lists,  p.smem};
  for (int i = 0; i < 17; ++i) out[i] = v[i];
  return 0;
}

extern "C" int irt_fused_optimized_scores_int8(const void* q, const void* qn, const void* rows,
                                               const void* scales, const void* mags, void* out,
                                               int nq, int n, int d, float w0, float w1,
                                               float w2, float w3, float w4, int live,
                                               void* stream) {
  const Weights w = make_weights(w0, w1, w2, w3, w4, live);
  Int8SweepPlan p;
  if (!k5_plan(nq, n, d, w.live, rows, &p)) return IRT_BAD_ARGS;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (p.tma) {
    if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
    // (d, n) int8 as boxes of (128 dims, tile rows), 128-byte swizzle, zeros
    // past its edges
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)d};
    const cuuint32_t box[2] = {(cuuint32_t)kSwBoxDims, (cuuint32_t)p.tile_rows};
    const cuuint32_t elem[2] = {1, 1};
    if (encode_tiled()(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(rows), dims,
                       strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return IRT_BAD_ARGS;
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
#define IRT_LAUNCH(dot, l1, linf) \
  return launch_int8_sweep<dot, l1, linf>(map, q, qn, rows, scales, mags, out, nq, n, d, w, p, st)
  IRT_LIVE_CASES(live_case(w))
#undef IRT_LAUNCH
  return IRT_BAD_ARGS;
}

// K5's launch plan as the kernel would take it on the current device: 0 and
// out[14] = (qw, groups, tile_rows, passes, resident, q_rows, q_pitch, boxes,
// stages, stage_bytes, tma, tiles, grid, smem), or IRT_BAD_ARGS where the
// kernel refuses the shape. `aligned`: the rows' base is 16-byte aligned.
extern "C" int irt_int8_sweep_plan(int nq, int n, int d, int live, int aligned, int sms,
                                   int* out) {
  Int8SweepPlan p;
  if (!int8_sweep_plan(nq, n, d, live & 31, aligned != 0, sms, &p)) return IRT_BAD_ARGS;
  const int v[14] = {p.qw,   p.groups, p.tile_rows,   p.passes, p.resident, p.q_rows, p.q_pitch,
                     p.boxes, p.stages, p.stage_bytes, p.tma,    p.tiles,    p.grid,   p.smem};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

