// Exact assignment's distance epilogue and running minimum for Hopper
// (sm_90a), bound to Python with ctypes (ivfhnsw_tpu_torch/ops/cuda/
// assign_min.py::top1_update).
//
// It replaces no Pallas kernel. It replaces XLA's fusion of one lax.scan
// step of the JAX package's streaming_topk_l2 at k=1
// (ivfhnsw_tpu/ops/distances.py:115-136, assign_top1 at :147): the norm
// adds, the block's top-1 and the merge with the running best. The score
// GEMM stays cuBLAS (torch.matmul, TF32 off), as the JAX package leaves it
// to XLA: a plain large product outside any kernel.
//
// On one score block ip [B, C] = queries @ points[s:s+C].T it computes, for
// each row b,
//
//   d[b, j]   = (-2 * ip[b, j] + q_sqnorm[b]) + p_sqnorm[j]      (f32, in
//               this order, each step rounded: the order of the plain
//               version's mul_(-2), add_(q), add_(p))
//   (m, j*)   = the minimum of d[b, :] and the first j that reaches it
//   (best_d[b], best_i[b]) = (m, s + j*)  only where m < best_d[b]
//
// so an earlier block wins a tie, and over all blocks the result is the
// first index among equal distances (torch.min's rule, lax.top_k's). A row
// holding a NaN distance leaves its best unchanged, as the plain version's
// NaN minimum fails the strict comparison.
//
// What bounds it on an H100: the one read of ip, 4 B a score (268 MB for a
// [4096, 16384] block: 0.080 ms at 3.35 TB/s); three f32 operations and a
// compare a score are far below the card's rate. Design: one block of 256
// threads per row, 16-byte streaming loads of ip (read once, kept out of
// L1/L2's way) when C % 4 == 0 and the pointers are 16-byte aligned, else
// scalar loads; each thread keeps its first minimum over its own columns,
// taken in increasing order, then a warp-shuffle (d, j) reduction and one
// step across the 8 warps, combining by d < d' || (d == d' && j < j'). No
// atomics, so a build is bit-reproducible run to run; the launch allocates
// nothing.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float dist(float ip, float q, float p) {
  // pinned roundings: nvcc may not contract these into an fma
  return __fadd_rn(__fadd_rn(__fmul_rn(-2.0f, ip), q), p);
}

__device__ __forceinline__ void take(float d, int j, float& bd, int& bj,
                                     int& nan) {
  nan |= (d != d);
  if (d < bd) {
    bd = d;
    bj = j;
  }
}

__device__ __forceinline__ void combine(float d, int j, float& bd, int& bj) {
  if (d < bd || (d == bd && j < bj)) {
    bd = d;
    bj = j;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    top1_update_kernel(const float* __restrict__ ip,
                       const float* __restrict__ q_sqnorm,
                       const float* __restrict__ p_sqnorm,
                       float* __restrict__ best_d,
                       long long* __restrict__ best_i, int C,
                       long long offset) {
  const int b = blockIdx.x;
  const float* row = ip + static_cast<size_t>(b) * C;
  const float q = q_sqnorm[b];
  float bd = INFINITY;
  int bj = INT_MAX;
  int nan = 0;
  if (kVec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(p_sqnorm);
    const int c4 = C >> 2;
#pragma unroll 4
    for (int t = threadIdx.x; t < c4; t += kThreads) {
      const float4 v = __ldcs(row4 + t);
      const float4 p = __ldg(p4 + t);
      const int j = t << 2;
      take(dist(v.x, q, p.x), j, bd, bj, nan);
      take(dist(v.y, q, p.y), j + 1, bd, bj, nan);
      take(dist(v.z, q, p.z), j + 2, bd, bj, nan);
      take(dist(v.w, q, p.w), j + 3, bd, bj, nan);
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < C; j += kThreads) {
      take(dist(__ldcs(row + j), q, __ldg(p_sqnorm + j)), j, bd, bj, nan);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float d = __shfl_xor_sync(0xffffffffu, bd, o);
    const int j = __shfl_xor_sync(0xffffffffu, bj, o);
    combine(d, j, bd, bj);
  }
  __shared__ float sd[kWarps];
  __shared__ int sj[kWarps];
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) {
    sd[w] = bd;
    sj[w] = bj;
  }
  nan = __syncthreads_or(nan);  // also orders the shared writes
  if (w != 0) return;
  bd = l < kWarps ? sd[l] : INFINITY;
  bj = l < kWarps ? sj[l] : INT_MAX;
  for (int o = kWarps / 2; o > 0; o >>= 1) {
    const float d = __shfl_xor_sync(0xffffffffu, bd, o);
    const int j = __shfl_xor_sync(0xffffffffu, bj, o);
    combine(d, j, bd, bj);
  }
  if (l == 0 && !nan && bd < best_d[b]) {
    best_d[b] = bd;
    best_i[b] = offset + bj;
  }
}

}  // namespace

// ip [B, C] f32 contiguous; q_sqnorm [B]; p_sqnorm [C]; best_d [B] f32 and
// best_i [B] int64 updated in place; offset = the block's first point id.
// Requires 0 < B, 0 < C < 2^31. Launches on `stream`, returns
// cudaGetLastError().
extern "C" int ivf_top1_update(const float* ip, const float* q_sqnorm,
                               const float* p_sqnorm, float* best_d,
                               long long* best_i, int B, int C,
                               long long offset, cudaStream_t stream) {
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(ip) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p_sqnorm) % 16 == 0;
  if (vec) {
    top1_update_kernel<true><<<B, kThreads, 0, stream>>>(
        ip, q_sqnorm, p_sqnorm, best_d, best_i, C, offset);
  } else {
    top1_update_kernel<false><<<B, kThreads, 0, stream>>>(
        ip, q_sqnorm, p_sqnorm, best_d, best_i, C, offset);
  }
  return static_cast<int>(cudaGetLastError());
}
