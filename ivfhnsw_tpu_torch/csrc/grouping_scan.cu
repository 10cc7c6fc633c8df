// Fused Grouping(+Pruning) posting-list scan for Hopper (sm_90a), bound to
// Python with ctypes (ivfhnsw_tpu_torch/ops/cuda/grouping_scan.py::
// grouping_scan_slots).
//
// Replaces the two TPU grouping scan kernels of the JAX package, together
// with the mask-and-bias pass they leave to XLA (grouping_scan.py:239-245,
// :387-395, :516-533):
//   K5  ivfhnsw_tpu/ops/pallas/grouping_scan.py:113  _grouping_kernel       (256-code chunk slots)
//   K6  ivfhnsw_tpu/ops/pallas/grouping_scan.py:248  _grouping_kernel_quad  (1024-code quad slots)
// The chunk/quad split is a choice of TPU DMA tile format; both compute the
// same function, which this kernel computes at either slot width `gran`:
//
//   out[b, s*gran + l] = bias[b,s] + norm_tab[norm_codes[r]]
//                        + t2[b, seg[b,s], subc[r]] + sum_m lut[b,m,codes[r,m]]
//                          with r = start[b,s] + l                 if l < len[b,s]
//                      = +inf                                      otherwise
//
// bias is term1 = (1-a)(||q-c||^2 - ||c||^2) of the slot's probe; t2
// [B,P,nsubc] f32 is term2 = a(||q-n||^2 - ||n||^2) per subgroup of each
// probe, +inf where the subgroup is pruned or empty; seg is the slot's probe
// index (several slots of one group share it). lut [B,M,256] f32 holds the
// -2 factor; norm_tab [256] f32 is the norm-PQ decode table; codes [N,M] u8,
// norm_codes [N] u8 and subc [N] u8 (each code's subcentroid index) are the
// posting-list store's flat arrays, read in place: no tiles, no pad rows, no
// group alignment. The caller guarantees start + len <= N, seg < P and
// subc < nsubc for every slot with len > 0 (ops/cuda/grouping_scan.py::
// grouping_schedule builds such schedules).
//
// +inf arithmetic: every term but term2 is finite, and term2 is finite or
// +inf, never -inf, so a pruned lane sums to +inf and never to NaN. The
// plain version adds the terms in this kernel's order (bias, norm, term2,
// m = 0..M-1), so the two agree bit for bit on the card.
//
// What bounds it on an H100. Per valid lane the kernel reads M+2 bytes of
// the store (18 B at M=16) from device memory or L2, does M+2 random 4-byte
// shared-memory lookups (LUT, norm, term2), and it writes 4 B for EVERY lane
// of the padded [B, nslots*gran] output. A group is scanned whole when any
// of its subgroups survives pruning, so pruned lanes cost what kept ones do;
// the wide f32 output and the shared-memory lookups bound it.
//
// What the design does about it. One thread block per query stages the
// query's M x 256 LUT, the norm table and its P x nsubc term2 table in
// shared memory once (17 KB + 8 KB at M=16, P=32, nsubc=64) and then walks
// all of the query's slots. Threads own lanes tid, tid+blockDim, ..., so
// code reads and output stores are coalesced; at M=16 a lane's code is one
// 16-byte load. Row addresses are 64-bit. Above 48 KB of shared memory the
// launch opts in to more (the wrapper refuses more than 227 KB).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KSUB = 256;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
grouping_scan_slots_kernel(const float* __restrict__ lut,           // [B, M, 256]
                           const float* __restrict__ norm_tab,      // [256]
                           const float* __restrict__ t2,            // [B, P, nsubc]
                           const uint8_t* __restrict__ codes,       // [N, M]
                           const uint8_t* __restrict__ norm_codes,  // [N]
                           const uint8_t* __restrict__ subc,        // [N]
                           const int64_t* __restrict__ start,       // [B, S]
                           const int32_t* __restrict__ len,         // [B, S]
                           const float* __restrict__ bias,          // [B, S]
                           const int32_t* __restrict__ seg,         // [B, S]
                           float* __restrict__ out,                 // [B, S*gran]
                           int nslots, int M, int gran, int ntab,
                           int nsubc, int vec16) {
  extern __shared__ float smem[];
  float* s_lut = smem;                   // M * 256
  float* s_norm = smem + M * KSUB;       // 256
  float* s_t2 = s_norm + KSUB;           // P * nsubc (= ntab)

  const int64_t b = blockIdx.x;
  const float* lut_b = lut + b * M * KSUB;
  const float* t2_b = t2 + b * ntab;
  for (int i = threadIdx.x; i < M * KSUB; i += blockDim.x) s_lut[i] = lut_b[i];
  for (int i = threadIdx.x; i < KSUB; i += blockDim.x) s_norm[i] = norm_tab[i];
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_t2[i] = t2_b[i];
  __syncthreads();

  const int64_t sb = b * nslots;
  float* out_b = out + sb * gran;
  for (int s = 0; s < nslots; ++s) {
    const int64_t st = start[sb + s];
    const int ln = len[sb + s];
    const float bs = bias[sb + s];
    const float* t2s = s_t2 + seg[sb + s] * nsubc;
    float* o = out_b + static_cast<int64_t>(s) * gran;
    for (int l = threadIdx.x; l < gran; l += blockDim.x) {
      float v = INFINITY;
      if (l < ln) {
        const int64_t r = st + l;
        // Same summation order as the plain version: bias, norm, term2,
        // then m = 0..M-1.
        float acc = bs + s_norm[norm_codes[r]];
        acc += t2s[subc[r]];
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
        v = acc;
      }
      o[l] = v;
    }
  }
}

}  // namespace

// Launches the scan on `stream`. Returns 0 or the CUDA error code of the
// launch (cudaGetLastError right after it); the kernel's own faults surface
// at the caller's next synchronisation.
extern "C" int ivf_grouping_scan_slots(
    const void* lut, const void* norm_tab, const void* t2, const void* codes,
    const void* norm_codes, const void* subc, const void* start,
    const void* len, const void* bias, const void* seg, void* out, int B,
    int nslots, int M, int gran, int P, int nsubc, void* stream) {
  if (B == 0 || nslots == 0 || gran == 0) return 0;
  const int ntab = P * nsubc;
  const size_t smem =
      (static_cast<size_t>(M + 1) * KSUB + static_cast<size_t>(ntab)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        grouping_scan_slots_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec16 =
      (M == 16) && ((reinterpret_cast<uintptr_t>(codes) & 15u) == 0);
  grouping_scan_slots_kernel<<<B, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const float*>(norm_tab),
      static_cast<const float*>(t2), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(norm_codes),
      static_cast<const uint8_t*>(subc), static_cast<const int64_t*>(start),
      static_cast<const int32_t*>(len), static_cast<const float*>(bias),
      static_cast<const int32_t*>(seg), static_cast<float*>(out), nslots, M,
      gran, ntab, nsubc, vec16);
  return static_cast<int>(cudaGetLastError());
}
