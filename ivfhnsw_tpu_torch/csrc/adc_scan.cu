// Fused ADC posting-list scans for Hopper (sm_90a), bound to Python with
// ctypes (ivfhnsw_tpu_torch/ops/cuda/adc_scan.py::adc_scan_slots and
// ::adc_scan_slots_min). Two kernels over one per-lane sum.
//
// 1. The wide scan replaces the two TPU scan kernels of the JAX package,
//    together with the mask-and-bias pass they leave to XLA
//    (adc_scan.py:338-341, :486-494):
//      K1  ivfhnsw_tpu/ops/pallas/adc_scan.py:216  _adc_kernel       (256-code chunk slots)
//      K2  ivfhnsw_tpu/ops/pallas/adc_scan.py:368  _adc_kernel_quad  (1024-code quad slots)
//    The chunk/quad split is a choice of TPU DMA tile format; both compute
//    the same function, which this kernel computes at either slot width
//    `gran`:
//
//      out[b, s*gran + l] = bias[b,s] + norm_tab[norm_codes[r]] + sum_m lut[b,m,codes[r,m]]
//                             with r = start[b,s] + l              if l < len[b,s]
//                         = +inf                                   otherwise
//
// 2. The min scan replaces the two phase-1 kernels of the JAX package's
//    exact two-phase top-k (proof at adc_scan.py:529-536):
//      K3  ivfhnsw_tpu/ops/pallas/adc_scan.py:545  _adc_kernel_min       (per-chunk minima)
//      K4  ivfhnsw_tpu/ops/pallas/adc_scan.py:685  _adc_kernel_quad_min  (per-quad minima)
//    It computes, at either slot width,
//
//      mins[b, s] = min over l < min(len[b,s], gran) of the same lane sum
//                 = +inf when len[b,s] == 0
//
//    The JAX kernels store the RAW minimum and add the bias outside, on
//    [B, n_units]. Here the bias goes inside, in the wide kernel's order
//    (bias, norm, m = 0..M-1; one device function below computes both), so
//    mins equals the wide output's per-slot amin bit for bit, and phase 2
//    selects slots in the same arithmetic that the rescan then reports. f32
//    rounding is monotone, so min(fl(b + x)) = fl(b + min x) over a slot's
//    lanes with one bias, and the result stays within the cross-engine
//    tolerance of JAX's raw-min-plus-bias.
//
// lut [B,M,256] f32 already holds the -2 factor (build_luts_ext semantics),
// norm_tab [256] f32 is the norm-PQ decode table, and codes [N,M] u8 /
// norm_codes [N] u8 are the posting-list store's flat arrays, read in place:
// no tiles, no pad rows, no list alignment. The caller guarantees
// start + len <= N for every slot with len > 0 (ops/cuda/adc_scan.py::
// probe_schedule builds such schedules).
//
// What bounds them on an H100. Per valid lane a kernel reads M+1 code bytes
// (17 B at M=16) from L2 or device memory and does M+1 random 4-byte lookups
// in the shared-memory LUT, at five machine operations each (shift, mask,
// add the table's base, load, add). The wide kernel also writes 4 B for
// EVERY lane of the padded [B, nslots*gran] output, empty and tail lanes
// included; that output is its byte bound. The min kernel writes 4 B per
// slot, so its byte bound is the LUTs (B x 16 KB) and the touched store
// rows, ten times below its time. Measured (PERF.md, tools/bank_probe.py):
// over a store whose codes never meet in a bank the min kernel runs 1.2x
// faster and the wide kernel no faster, so bank conflicts of the random
// lookups (all lanes of a warp read one LUT row, the bank is code mod 32)
// cost the min kernel a fifth and the wide kernel nothing; keeping two rows
// per lane in flight or prefetching the next slot's schedule changes
// neither, and codes served from L1 instead of L2 gain a few percent. Right
// behind the conflicts stands the schedulers' rate: 96 machine operations
// per warp and code on 4 schedulers per SM come to 0.25 ms of the min
// kernel's 0.47.
// A bank-skewed LUT that removes the conflicts (the skew variants of
// csrc/scan_lab.cu) pays for them in operations and registers: about a
// tenth faster as the min kernel, 30% slower as the wide kernel at 256-code
// slots, and the two kernels must share one summation order, so it stays in
// the lab.
//
// What the design does about it. One thread block per query stages that
// query's M x 256 LUT and the norm table in shared memory once (17 KB at
// M=16: 8 blocks of 8 warps per SM, 32 registers a thread) and then walks
// all of the query's slots, so LUT bytes come from device memory once per
// query; reloading them per 256-code slot would read ~4x more LUT bytes than
// code bytes. At M=16 a lane's code is one 16-byte load and every LUT row's
// offset is an immediate. Row addresses are 64-bit (start*M passes 2^31 at
// ~134M codes).
//   wide: threads own lanes tid, tid+blockDim, ..., so code reads and output
//         stores are coalesced. The output streams through L2 once
//         (st.global.cs) and should not evict the code store; a run of empty
//         slots (half of a schedule's slots) is one fill of 16-byte +inf
//         stores by all threads (fill_inf, scan_common.cuh).
//   min:  each warp takes slots warp, warp+nwarps, ...; its lanes stride
//         the slot's codes (coalesced rows), keep a running fminf, and a
//         __shfl_xor_sync tree reduces the warp; lane 0 stores one float.
//         No __syncthreads after staging and no atomics; an empty slot
//         costs one +inf store.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using scan_common::fill_inf;

constexpr int KSUB = 256;
constexpr int THREADS = 256;

// Stage the query's LUT and the norm table in shared memory.
__device__ __forceinline__ void stage_tables(float* s_lut, float* s_norm,
                                             const float* __restrict__ lut_b,
                                             const float* __restrict__ norm_tab,
                                             int M) {
  for (int i = threadIdx.x; i < M * KSUB; i += blockDim.x) s_lut[i] = lut_b[i];
  for (int i = threadIdx.x; i < KSUB; i += blockDim.x) s_norm[i] = norm_tab[i];
  __syncthreads();
}

// One lane's distance, summed as the plain versions sum it: bias, norm,
// then m = 0..M-1. Both kernels call this, so their results agree bit for
// bit.
__device__ __forceinline__ float lane_sum(const float* s_lut,
                                          const float* s_norm,
                                          const uint8_t* __restrict__ codes,
                                          const uint8_t* __restrict__ norm_codes,
                                          int64_t r, float bs, int M,
                                          int vec16) {
  float acc = bs + s_norm[norm_codes[r]];
  if (vec16) {
    const uint4 c = *reinterpret_cast<const uint4*>(codes + r * 16);
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc += s_lut[(q * 4 + t) * KSUB + ((w[q] >> (8 * t)) & 0xff)];
      }
    }
  } else {
    const uint8_t* c = codes + r * M;
    for (int m = 0; m < M; ++m) acc += s_lut[m * KSUB + c[m]];
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
adc_scan_slots_kernel(const float* __restrict__ lut,           // [B, M, 256]
                      const float* __restrict__ norm_tab,      // [256]
                      const uint8_t* __restrict__ codes,       // [N, M]
                      const uint8_t* __restrict__ norm_codes,  // [N]
                      const int64_t* __restrict__ start,       // [B, S]
                      const int32_t* __restrict__ len,         // [B, S]
                      const float* __restrict__ bias,          // [B, S]
                      float* __restrict__ out,                 // [B, S*gran]
                      int nslots, int M, int gran, int vec16) {
  extern __shared__ float smem[];
  float* s_lut = smem;               // M * 256
  float* s_norm = smem + M * KSUB;   // 256

  const int64_t b = blockIdx.x;
  stage_tables(s_lut, s_norm, lut + b * M * KSUB, norm_tab, M);

  const int64_t sb = b * nslots;
  float* out_b = out + sb * gran;
  for (int s = 0; s < nslots; ++s) {
    const int ln = len[sb + s];
    float* o = out_b + static_cast<int64_t>(s) * gran;
    if (ln <= 0) {  // this slot and the empty ones after it, in one fill
      int e = s + 1;
      while (e < nslots && len[sb + e] <= 0) ++e;
      fill_inf(o, static_cast<int64_t>(e - s) * gran);
      s = e - 1;
      continue;
    }
    const int64_t st = start[sb + s];
    const float bs = bias[sb + s];
    for (int l = threadIdx.x; l < gran; l += blockDim.x) {
      __stcs(o + l, l < ln ? lane_sum(s_lut, s_norm, codes, norm_codes,
                                      st + l, bs, M, vec16)
                           : INFINITY);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
adc_scan_slots_min_kernel(const float* __restrict__ lut,           // [B, M, 256]
                          const float* __restrict__ norm_tab,      // [256]
                          const uint8_t* __restrict__ codes,       // [N, M]
                          const uint8_t* __restrict__ norm_codes,  // [N]
                          const int64_t* __restrict__ start,       // [B, S]
                          const int32_t* __restrict__ len,         // [B, S]
                          const float* __restrict__ bias,          // [B, S]
                          float* __restrict__ mins,                // [B, S]
                          int nslots, int M, int gran, int vec16) {
  extern __shared__ float smem[];
  float* s_lut = smem;               // M * 256
  float* s_norm = smem + M * KSUB;   // 256

  const int64_t b = blockIdx.x;
  stage_tables(s_lut, s_norm, lut + b * M * KSUB, norm_tab, M);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int64_t sb = b * nslots;
  for (int s = warp; s < nslots; s += nwarps) {
    const int ln = min(len[sb + s], gran);   // warp-uniform
    float best = INFINITY;
    if (ln > 0) {
      const int64_t st = start[sb + s];
      const float bs = bias[sb + s];
      for (int l = lane; l < ln; l += 32) {
        best = fminf(best, lane_sum(s_lut, s_norm, codes, norm_codes, st + l,
                                    bs, M, vec16));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      best = fminf(best, __shfl_xor_sync(0xffffffffu, best, o));
    }
    if (lane == 0) mins[sb + s] = best;
  }
}

// Shared memory of one block, opted in above the 48 KB default. Returns 0
// or a CUDA error code.
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

int use_vec16(int M, const void* codes) {
  return (M == 16) && ((reinterpret_cast<uintptr_t>(codes) & 15u) == 0);
}

}  // namespace

// Each entry point launches its kernel on `stream` and returns 0 or the
// CUDA error code of the launch (cudaGetLastError right after it); the
// kernel's own faults surface at the caller's next synchronisation.

extern "C" int ivf_adc_scan_slots(const void* lut, const void* norm_tab,
                                  const void* codes, const void* norm_codes,
                                  const void* start, const void* len,
                                  const void* bias, void* out, int B,
                                  int nslots, int M, int gran, void* stream) {
  if (B == 0 || nslots == 0 || gran == 0) return 0;
  const size_t smem = static_cast<size_t>(M + 1) * KSUB * sizeof(float);
  if (const int e = set_smem(adc_scan_slots_kernel, smem)) return e;
  adc_scan_slots_kernel<<<B, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const float*>(norm_tab),
      static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(norm_codes),
      static_cast<const int64_t*>(start), static_cast<const int32_t*>(len),
      static_cast<const float*>(bias), static_cast<float*>(out), nslots, M,
      gran, use_vec16(M, codes));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ivf_adc_scan_slots_min(const void* lut, const void* norm_tab,
                                      const void* codes,
                                      const void* norm_codes,
                                      const void* start, const void* len,
                                      const void* bias, void* mins, int B,
                                      int nslots, int M, int gran,
                                      void* stream) {
  if (B == 0 || nslots == 0) return 0;
  const size_t smem = static_cast<size_t>(M + 1) * KSUB * sizeof(float);
  if (const int e = set_smem(adc_scan_slots_min_kernel, smem)) return e;
  adc_scan_slots_min_kernel<<<B, THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const float*>(norm_tab),
      static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(norm_codes),
      static_cast<const int64_t*>(start), static_cast<const int32_t*>(len),
      static_cast<const float*>(bias), static_cast<float*>(mins), nslots, M,
      gran, use_vec16(M, codes));
  return static_cast<int>(cudaGetLastError());
}
