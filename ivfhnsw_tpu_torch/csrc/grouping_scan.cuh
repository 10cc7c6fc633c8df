// The fused Grouping(+Pruning) posting-list scan for Hopper (sm_90a) as one
// kernel template. grouping_scan.cu instantiates the design the search
// engine runs; grouping_lab.cu instantiates every step from the kernel as
// first ported up to it, so that tools/grouping_probe.py can time the steps
// against each other in turns on one card.
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
// m = 0..M-1), so the two agree bit for bit on the card. With SKIP a lane
// whose term2 is +inf stores +inf without loading its code row or looking
// anything else up: finite + (+inf) = +inf in f32, so the result is the
// same bits as the full sum's. Any other term2 (a NaN included) takes the
// full sum.
//
// What bounds it on an H100. The kernel is, by bytes, a fill: at the
// flagship point a twentieth of the lanes of the padded [B, nslots*gran]
// f32 output hold a code (a pruned probe gets no slot, and the slot count is
// the worst case over queries), and the output is nine tenths of all bytes
// moved. Per kept lane it reads M+2 bytes of the store (18 B at M=16) and
// does M+2 random 4-byte shared-memory lookups (LUT, norm, term2); per
// pruned lane of a scanned group one subc byte and one lookup. Measured
// (NVIDIA H100 80GB HBM3 at 700 W, tools/grouping_probe.py): the fill runs at two thirds of the rate of a
// plain fill of the same bytes, and the third is lost to the 25 KB of
// tables per query that are read from device memory among the writes.
//
// What the design does about it. One thread block per query stages the
// query's M x 256 LUT, the norm table and its P x nsubc term2 table in
// shared memory once (17 KB + 8 KB at M=16, P=32, nsubc=64) and then walks
// the query's slots. Threads own lanes tid, tid+blockDim, ..., so code
// reads and output stores are coalesced; at M=16 a lane's code is one
// 16-byte load. Row addresses are 64-bit. Above 48 KB of shared memory the
// launch opts in to more (the wrapper refuses more than 227 KB). The steps
// beyond the first port, each a template flag:
//   FILL    padding leaves the lane loop: a run of empty slots, and the tail
//           of a partly filled slot past its length rounded up to 4 lanes,
//           is written by all threads with 16-byte stores (fill_inf), with
//           no schedule read per slot and no lane test per float;
//   STREAM  every store of the output is st.global.cs;
//   SKIP    the pruned-lane shortcut above;
//   STAGE   the block's schedule (start, len, bias, seg: 20 B a slot) is
//           copied to shared memory once, so the slot loop waits on no
//           global read before it can address a slot's codes;
//   BULK    a run of empty slots is written by the copy engine: one thread
//           starts TMA bulk copies (cp.async.bulk, shared to global) from an
//           8 KB buffer of +inf in shared memory, so the fill costs the SM
//           one instruction per 8 KB instead of one per 16 bytes.
//   BINS    (the engine's second instantiation) also writes bins [B,
//           S*gran/32], bins[b, s*gran/32 + j] = the minimum of lanes
//           32j .. 32j+31 of slot s, which the bin-32 top-k selects bins
//           by. Thread t owns lanes t + 256i, so a warp's 32 lanes of one
//           step are one bin: folded by a __shfl_xor_sync tree of fminf,
//           stored by lane 0 with the lanes' policy. With FILL the lane
//           loop then runs to the length rounded up to 32 lanes (not 4), so
//           every warp that folds a bin has all its lanes; the bins of the
//           fill past it and of empty slots are +inf. Needs gran % 32 == 0.
//           No lane is NaN (above), so the minima equal an amin over the
//           stored lanes bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace grouping_scan {

constexpr int KSUB = 256;
constexpr int THREADS = 256;

// Floats of shared memory before the staged schedule: LUT, norm table and
// term2 table, rounded up to an even count so that the 8-byte start rows
// that follow are aligned.
__host__ __device__ inline int table_floats(int M, int ntab) {
  return ((M + 1) * KSUB + ntab + 1) & ~1;
}

// One filled lane: bias + norm + term2 + the M LUT rows of store row r,
// summed in the plain version's order (bias, norm, term2, then m = 0..M-1).
// With SKIP a lane whose term2 is +inf returns +inf without touching its
// code row.
template <bool SKIP>
__device__ __forceinline__ float lane_value(
    const float* s_lut, const float* s_norm, const float* t2s,
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ norm_codes,
    const uint8_t* __restrict__ subc, int64_t r, float bs, int M, int vec16) {
  const float t = t2s[subc[r]];
  if (SKIP && t == INFINITY) return INFINITY;
  float acc = bs + s_norm[norm_codes[r]];
  acc += t;
  if (vec16) {
    const uint4 c = *reinterpret_cast<const uint4*>(codes + r * 16);
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc += s_lut[(q * 4 + u) * KSUB + ((w[q] >> (8 * u)) & 0xff)];
      }
    }
  } else {
    const uint8_t* c = codes + r * M;
    for (int m = 0; m < M; ++m) acc += s_lut[m * KSUB + c[m]];
  }
  return acc;
}

constexpr int INF_FLOATS = 2048;  // the BULK fill's buffer of +inf (8 KB)

// n floats of +inf at o by TMA bulk copies from the block's +inf buffer,
// started by thread 0 as one bulk group; all threads fill instead where o or
// n do not fit the copy engine's 16-byte granularity. The kernel waits for
// the groups' reads of shared memory before it ends.
template <bool STREAM>
__device__ __forceinline__ void fill_bulk(float* o, int64_t n,
                                          const float* s_inf) {
  if (((reinterpret_cast<uintptr_t>(o) | static_cast<uintptr_t>(n * 4)) &
       15u) != 0) {
    scan_common::fill_inf<STREAM>(o, n);
    return;
  }
  if (threadIdx.x == 0) {
    const uint32_t src =
        static_cast<uint32_t>(__cvta_generic_to_shared(s_inf));
    char* dst = reinterpret_cast<char*>(o);
    const int64_t bytes = n * 4;
    for (int64_t off = 0; off < bytes; off += INF_FLOATS * 4) {
      const uint32_t sz = static_cast<uint32_t>(
          min(static_cast<int64_t>(INF_FLOATS * 4), bytes - off));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
              "l"(dst + off),
          "r"(src), "r"(sz)
          : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

template <bool FILL, bool STREAM, bool SKIP, bool STAGE, bool BULK,
          bool BINS>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ lut,           // [B, M, 256]
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
            float* __restrict__ bins,                // [B, S*gran/32] (BINS)
            int nslots, int M, int gran, int ntab, int nsubc, int vec16) {
  extern __shared__ __align__(16) float smem[];
  float* s_lut = smem;                   // M * 256
  float* s_norm = smem + M * KSUB;       // 256
  float* s_t2 = s_norm + KSUB;           // P * nsubc (= ntab)

  const int64_t b = blockIdx.x;
  const int64_t sb = b * nslots;
  const float* lut_b = lut + b * M * KSUB;
  const float* t2_b = t2 + b * ntab;
  for (int i = threadIdx.x; i < M * KSUB; i += blockDim.x) s_lut[i] = lut_b[i];
  for (int i = threadIdx.x; i < KSUB; i += blockDim.x) s_norm[i] = norm_tab[i];
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_t2[i] = t2_b[i];

  const float* s_inf = nullptr;
  if (BULK) {
    __shared__ __align__(128) float inf_buf[INF_FLOATS];
    for (int i = threadIdx.x; i < INF_FLOATS; i += blockDim.x) {
      inf_buf[i] = INFINITY;
    }
    // the copy engine reads shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    s_inf = inf_buf;
  }

  // The block's schedule: in shared memory with STAGE, else in place.
  const int64_t* q_start = start + sb;
  const int32_t* q_len = len + sb;
  const float* q_bias = bias + sb;
  const int32_t* q_seg = seg + sb;
  if (STAGE) {
    int64_t* s_start = reinterpret_cast<int64_t*>(smem + table_floats(M, ntab));
    int32_t* s_len = reinterpret_cast<int32_t*>(s_start + nslots);
    float* s_bias = reinterpret_cast<float*>(s_len + nslots);
    int32_t* s_seg = reinterpret_cast<int32_t*>(s_bias + nslots);
    for (int i = threadIdx.x; i < nslots; i += blockDim.x) {
      s_start[i] = q_start[i];
      s_len[i] = q_len[i];
      s_bias[i] = q_bias[i];
      s_seg[i] = q_seg[i];
    }
    q_start = s_start;
    q_len = s_len;
    q_bias = s_bias;
    q_seg = s_seg;
  }
  __syncthreads();

  float* out_b = out + sb * gran;
  const int gb = gran >> 5;  // bins a slot (BINS)
  float* bins_b = BINS ? bins + sb * gb : nullptr;
  for (int s = 0; s < nslots; ++s) {
    const int ln = min(q_len[s], gran);
    float* o = out_b + static_cast<int64_t>(s) * gran;
    float* ob = bins_b + static_cast<int64_t>(s) * gb;
    if (FILL && ln <= 0) {  // this slot and the empty ones after it, in one fill
      int e = s + 1;
      while (e < nslots && q_len[e] <= 0) ++e;
      const int64_t n = static_cast<int64_t>(e - s) * gran;
      if (BULK) {
        fill_bulk<STREAM>(o, n, s_inf);
      } else {
        scan_common::fill_inf<STREAM>(o, n);
      }
      if (BINS) scan_common::fill_inf<STREAM>(ob, (e - s) * gb);
      s = e - 1;
      continue;
    }
    const int64_t st = q_start[s];
    const float bs = q_bias[s];
    const float* t2s = s_t2 + q_seg[s] * nsubc;
    // Lanes that take the lane loop: all of them, or with FILL the filled
    // ones rounded up to the 4 lanes of a 16-byte store (with BINS, to the
    // 32 lanes of a bin).
    const int hi =
        FILL ? min(gran, BINS ? (ln + 31) & ~31 : (ln + 3) & ~3) : gran;
    for (int l = threadIdx.x; l < hi; l += blockDim.x) {
      const float v =
          l < ln ? lane_value<SKIP>(s_lut, s_norm, t2s, codes, norm_codes,
                                    subc, st + l, bs, M, vec16)
                 : INFINITY;
      scan_common::store_out<STREAM, float>(o + l, v);
      if (BINS) scan_common::store_bin<STREAM>(ob, l, v);
    }
    if (FILL) scan_common::fill_inf<STREAM>(o + hi, gran - hi);
    if (FILL && BINS) {
      scan_common::fill_inf<STREAM>(ob + (hi >> 5), gb - (hi >> 5));
    }
  }
  if (BULK && threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// Launches one instantiation on `stream`; with BINS, bins is its bin
// minima's output (gran % 32 == 0). Returns 0 or the CUDA error code of the
// launch (cudaGetLastError right after it); the kernel's own faults surface
// at the caller's next synchronisation.
template <bool FILL, bool STREAM, bool SKIP, bool STAGE, bool BULK,
          bool BINS = false>
int launch(const void* lut, const void* norm_tab, const void* t2,
           const void* codes, const void* norm_codes, const void* subc,
           const void* start, const void* len, const void* bias,
           const void* seg, void* out, int B, int nslots, int M, int gran,
           int P, int nsubc, void* stream, void* bins = nullptr) {
  if (B == 0 || nslots == 0 || gran == 0) return 0;
  if (BINS && (bins == nullptr || gran % 32 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntab = P * nsubc;
  size_t smem =
      (static_cast<size_t>(M + 1) * KSUB + static_cast<size_t>(ntab)) *
      sizeof(float);
  if (STAGE) {
    smem = static_cast<size_t>(table_floats(M, ntab)) * sizeof(float) +
           static_cast<size_t>(nslots) * 20;
  }
  auto kernel = scan_kernel<FILL, STREAM, SKIP, STAGE, BULK, BINS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec16 =
      (M == 16) && ((reinterpret_cast<uintptr_t>(codes) & 15u) == 0);
  kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const float*>(norm_tab),
      static_cast<const float*>(t2), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(norm_codes),
      static_cast<const uint8_t*>(subc), static_cast<const int64_t*>(start),
      static_cast<const int32_t*>(len), static_cast<const float*>(bias),
      static_cast<const int32_t*>(seg), static_cast<float*>(out),
      static_cast<float*>(bins), nslots, M, gran, ntab, nsubc, vec16);
  return static_cast<int>(cudaGetLastError());
}

// ---- the two-pass kernel ---------------------------------------------------
//
// On a schedule of empty slots the one-pass kernel above takes 1.3-1.4 times
// as long as one fill of the same bytes (NVIDIA H100 80GB HBM3 at 700 W,
// tools/grouping_probe.py, "empty schedule"). This kernel tests whether that is the wait for the 25 KB of
// tables before a block's first store, and the walk over the schedule: it
// asks for the tables with asynchronous copies (cp.async, 16 bytes each, no
// register in between), stages the slot lengths (4 B a slot) and writes ALL
// padding first, in one flat loop over the row's 16-byte groups in which
// every thread tests a staged length, so the stores run while the tables
// arrive. Then it waits for the tables and computes the filled lanes of the
// non-empty slots, which it finds from one ballot bit per slot instead of a
// walk. Same function, same sums, streaming stores and the pruned-lane
// shortcut. Measured: a few percent faster than the one-pass kernel at
// 256-code slots and level at 1024, at 40 registers for 32, so the engine
// keeps the one-pass kernel; the rest of the gap is the tables' reads from
// device memory among the writes, whenever they happen.

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* src) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst))),
      "l"(src)
      : "memory");
}

// All threads: n floats from src to shared dst (16-byte aligned), by
// asynchronous 16-byte copies where src and n allow, else through
// registers. The caller commits and waits.
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0 && (n & 3) == 0) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) {
      cp_async16(dst + i, src + i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Bytes of shared memory after the tables: the staged lengths and one
// non-empty bit per slot.
__host__ __device__ inline size_t overlap_extra_bytes(int nslots) {
  return static_cast<size_t>(nslots) * 4 +
         static_cast<size_t>((nslots + 31) / 32) * 4;
}

__global__ void __launch_bounds__(THREADS)
scan_overlap_kernel(const float* __restrict__ lut,           // [B, M, 256]
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
                    int nslots, int M, int gran, int ntab, int nsubc,
                    int vec16) {
  extern __shared__ __align__(16) float smem[];
  float* s_lut = smem;                   // M * 256
  float* s_norm = smem + M * KSUB;       // 256
  float* s_t2 = s_norm + KSUB;           // P * nsubc (= ntab)
  int32_t* s_len = reinterpret_cast<int32_t*>(smem + table_floats(M, ntab));
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_len + nslots);

  const int64_t b = blockIdx.x;
  const int64_t sb = b * nslots;
  stage_async(s_lut, lut + b * M * KSUB, M * KSUB);
  stage_async(s_norm, norm_tab, KSUB);
  stage_async(s_t2, t2 + b * ntab, ntab);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) {
    s_len[i] = max(0, min(len[sb + i], gran));
  }
  __syncthreads();

  const int nwords = (nslots + 31) >> 5;
  for (int w = threadIdx.x >> 5; w < nwords; w += blockDim.x >> 5) {
    const int s = w * 32 + (threadIdx.x & 31);
    const unsigned m =
        __ballot_sync(0xffffffffu, s < nslots && s_len[s] > 0);
    if ((threadIdx.x & 31) == 0) s_mask[w] = m;
  }

  // Pass 1, the padding: every lane at or past its slot's length rounded up
  // to 4, as 16-byte stores where the row allows.
  float* out_b = out + sb * gran;
  if ((reinterpret_cast<uintptr_t>(out_b) & 15u) == 0 && (gran & 3) == 0) {
    const unsigned g4 = static_cast<unsigned>(gran) >> 2;
    const unsigned total4 = static_cast<unsigned>(nslots) * g4;
    const float4 inf4 = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    float4* o4 = reinterpret_cast<float4*>(out_b);
    for (unsigned i = threadIdx.x; i < total4; i += blockDim.x) {
      const unsigned s = i / g4;
      if ((i - s * g4) * 4 >= static_cast<unsigned>(s_len[s])) {
        __stcs(o4 + i, inf4);
      }
    }
  } else {
    const unsigned total = static_cast<unsigned>(nslots) * gran;
    for (unsigned i = threadIdx.x; i < total; i += blockDim.x) {
      const unsigned s = i / gran;
      const int hi = min(gran, (s_len[s] + 3) & ~3);
      if (i - s * gran >= static_cast<unsigned>(hi)) {
        __stcs(out_b + i, INFINITY);
      }
    }
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Pass 2, the filled lanes of the non-empty slots.
  for (int w = 0; w < nwords; ++w) {
    unsigned m = s_mask[w];
    while (m) {
      const int s = w * 32 + __ffs(m) - 1;
      m &= m - 1;
      const int ln = s_len[s];
      const int64_t st = start[sb + s];
      const float bs = bias[sb + s];
      const float* t2s = s_t2 + seg[sb + s] * nsubc;
      float* o = out_b + static_cast<int64_t>(s) * gran;
      const int hi = min(gran, (ln + 3) & ~3);
      for (int l = threadIdx.x; l < hi; l += blockDim.x) {
        __stcs(o + l, l < ln ? lane_value<true>(s_lut, s_norm, t2s, codes,
                                                norm_codes, subc, st + l, bs,
                                                M, vec16)
                             : INFINITY);
      }
    }
  }
}

// Launches the two-pass kernel on `stream`; the caller guarantees
// nslots * gran < 2^31. Returns 0 or the CUDA error code of the launch.
inline int launch_overlap(const void* lut, const void* norm_tab,
                          const void* t2, const void* codes,
                          const void* norm_codes, const void* subc,
                          const void* start, const void* len,
                          const void* bias, const void* seg, void* out, int B,
                          int nslots, int M, int gran, int P, int nsubc,
                          void* stream) {
  if (B == 0 || nslots == 0 || gran == 0) return 0;
  const int ntab = P * nsubc;
  const size_t smem =
      static_cast<size_t>(table_floats(M, ntab)) * sizeof(float) +
      overlap_extra_bytes(nslots);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec16 =
      (M == 16) && ((reinterpret_cast<uintptr_t>(codes) & 15u) == 0);
  scan_overlap_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const float*>(norm_tab),
      static_cast<const float*>(t2), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(norm_codes),
      static_cast<const uint8_t*>(subc), static_cast<const int64_t*>(start),
      static_cast<const int32_t*>(len), static_cast<const float*>(bias),
      static_cast<const int32_t*>(seg), static_cast<float*>(out), nslots, M,
      gran, ntab, nsubc, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grouping_scan
