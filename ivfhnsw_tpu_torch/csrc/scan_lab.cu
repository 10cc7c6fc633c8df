// Scan-lab kernels for Hopper (sm_90a): timing variants of the ADC scan of
// csrc/adc_scan.cu, bound to Python with ctypes
// (ivfhnsw_tpu_torch/ops/cuda/scan_lab.py). They are the Hopper counterparts
// of the TPU lab rigs of tools/kernel_lab.py:
//
//   L1  tools/kernel_lab.py:87   _adc_kernel_v2       one DMA per 4-tile run
//   L2  tools/kernel_lab.py:525  _adc_kernel_quad     quad tiles, replicated LUT
//       tools/kernel_lab.py:449  _adc_kernel_quad_nb  the same, branchless
//   L3  tools/kernel_lab.py:207  _adc_kernel_nodma    compute only
//       tools/kernel_lab.py:236  _adc_kernel_dmaonly  copy only
//       tools/kernel_lab.py:285  _adc_kernel_v1b      every wait before compute
//   L4  tools/kernel_lab.py:694  _adc_kernel_cps      chunks per step x depth
//
// The TPU rigs price per-tile DMA descriptors, semaphore waits, scalar
// branches and sublane layouts. Each kernel here keeps the question its rig
// asks and asks it of this card's mechanisms: copies into a shared-memory
// ring (cp.async 16-byte copies, or TMA bulk copies completing on an
// mbarrier), shared-memory banks, and occupancy. The kernels read the flat
// store (codes [N,M] u8, norm_codes [N] u8) and the slot schedule
// (start [B,S] i64, len [B,S] i32, bias [B,S] f32) of the production scan,
// never the TPU tile formats. One thread block per query, as in production.
//
// The full-function variants compute adc_scan.cu's function (the lane sum
// bias, norm, m = 0..M-1 in that order), so their output equals the
// production kernels' bit for bit:
//
//   wide: out[b, s*gran + l] = bias + norm_tab[n_r] + sum_m lut[b,m,c_{r,m}]
//                              for l < len[b,s] (r = start[b,s] + l), else +inf
//   min:  out[b, s] = min over l < len[b,s] of the same, +inf for an empty slot
//
// Two kernel templates:
//
// lab_runs_kernel<DEPTH> (L1, gran 1024). A TPU run is four tiles in one DMA
// with one semaphore. Here one thread issues one cp.async.bulk per slot for
// its code bytes and one for its norm bytes, both completing on the stage's
// mbarrier with their byte count, into a ring of DEPTH stages; every thread
// waits on the mbarrier's phase parity ((slot / DEPTH) & 1) and computes from
// shared memory. A bulk copy needs a 16-byte-aligned source, destination and
// size: code rows are aligned at M=16, norm codes and M=8 rows are not, so
// each copy takes the aligned window that covers its bytes and the lanes
// read at the offset inside it. The window's last 16 bytes may run past the
// end of the array; those (at most 15) bytes come by plain loads instead.
//
// lab_pipe_kernel<GRAN, C, DEPTH, SPS, BATCHED, BRANCHLESS, MODE, EPI> (L2,
// L3, L4). A ring of DEPTH stages, each holding one slot's rows fetched by
// 16-byte cp.async.cg copies of the aligned window (the array's last chunk
// through the src-size operand, which zero-fills), one commit group per
// slot. Each step processes SPS slots (the rigs' cps / cpsq) and then
// refills their stages with the slots DEPTH ahead; a slot waits on its group
// (cp.async.wait_group) and a __syncthreads, or with BATCHED (v1b,
// batched_wait) the step waits on all of its SPS groups before computing any.
//   C:          copies of the query's LUT (and norm table) in shared memory.
//               Copy c of entry k sits at word k*C + c and lane l reads copy
//               l % C, so the random lookups of a warp spread over C times as
//               many banks: the direct test of the bank-conflict hypothesis
//               for what bounds the production kernels. (The quad tile of L2
//               replicates each LUT row four times for the same reason; its
//               `arith` axis selects between halves of a 128-lane gather,
//               which a 256-entry shared-memory row does not have.)
//   BRANCHLESS: every slot copies and computes a full GRAN rows (an empty
//               slot rows from 0), and the epilogue writes +inf where
//               l >= len; every copy issued is waited on before exit.
//   MODE:       FULL, the function above; COMPUTE_ONLY, no device-memory
//               code reads in the slot loop: rows [tile_row, tile_row + GRAN)
//               are staged once and every slot's lanes l < len look up row
//               tile_row + l, raw (no bias); COPY_ONLY, the full copy
//               pipeline, and each lane l < len sums its bytes as f32
//               (norm_codes[r] + sum_m codes[r,m]) instead of looking them up.
//               All three allocate the same shared memory, so their
//               occupancy is equal and their times subtract.
//   EPI:        WIDE, the [B, S*GRAN] output; MIN, the K3/K4 slot minimum
//               [B, S] (fminf, shuffle tree, then a fixed-order reduction of
//               the warps' minima), without the wide output's stores.
//
// What bounds them: per valid lane M+1 code bytes from L2 or device memory
// and M+1 random 4-byte shared-memory lookups; the wide epilogue writes 4 B
// for every lane of the padded output. The lab exists to measure which of
// those sets the pace (PERF.md); it does not change the search path.
//
// Every entry point has one signature: the seven inputs, the output, B,
// nslots, M, N (rows of the store), tile_row (COMPUTE_ONLY), smem_floor (the
// launch takes at least this much dynamic shared memory, to hold occupancy
// equal across variants), the stream, and info: when info is not null the
// entry point writes {blocks per SM, dynamic shared-memory bytes} there and
// launches nothing. It returns 0 or the CUDA error of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KSUB = 256;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int BAR_BYTES = 128;  // room for the runs kernel's mbarriers

constexpr int FULL = 0, COMPUTE_ONLY = 1, COPY_ONLY = 2;
constexpr int WIDE = 0, MIN = 1;

struct Args {
  const float* lut;           // [B, M, 256]
  const float* norm_tab;      // [256]
  const uint8_t* codes;       // [N, M], 16-byte aligned
  const uint8_t* norm_codes;  // [N], 16-byte aligned
  const int64_t* start;       // [B, S]
  const int32_t* len;         // [B, S]
  const float* bias;          // [B, S]
  float* out;                 // [B, S*gran] or [B, S]
  int nslots;
  int M;
  int64_t N;
  int64_t tile_row;
};

__host__ __device__ __forceinline__ int64_t round16(int64_t x) {
  return (x + 15) & ~static_cast<int64_t>(15);
}
__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}
__device__ __forceinline__ int64_t max64(int64_t x, int64_t y) {
  return x > y ? x : y;
}

// One ring stage: a slot's code rows, then its norm codes, each as the
// 16-byte-aligned window covering them (at most 16 bytes longer).
__host__ __device__ __forceinline__ int64_t codes_region(int gran, int M) {
  return round16(static_cast<int64_t>(gran) * M) + 16;
}
__host__ __device__ __forceinline__ int64_t stage_bytes(int gran, int M) {
  return codes_region(gran, M) + round16(gran) + 16;
}
__host__ __device__ __forceinline__ int64_t lut_bytes(int M, int C) {
  return static_cast<int64_t>(M + 1) * KSUB * C * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async (16-byte copies, commit groups) -----------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait_group takes an immediate: dispatch a count that is a constant once
// the caller's loop is unrolled (a larger count than 31 waits for all).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
#define LAB_WAIT_CASE(K) \
  case K:                \
    cp_async_wait<K>();  \
    return;
    LAB_WAIT_CASE(0) LAB_WAIT_CASE(1) LAB_WAIT_CASE(2) LAB_WAIT_CASE(3)
    LAB_WAIT_CASE(4) LAB_WAIT_CASE(5) LAB_WAIT_CASE(6) LAB_WAIT_CASE(7)
    LAB_WAIT_CASE(8) LAB_WAIT_CASE(9) LAB_WAIT_CASE(10) LAB_WAIT_CASE(11)
    LAB_WAIT_CASE(12) LAB_WAIT_CASE(13) LAB_WAIT_CASE(14) LAB_WAIT_CASE(15)
    LAB_WAIT_CASE(16) LAB_WAIT_CASE(17) LAB_WAIT_CASE(18) LAB_WAIT_CASE(19)
    LAB_WAIT_CASE(20) LAB_WAIT_CASE(21) LAB_WAIT_CASE(22) LAB_WAIT_CASE(23)
    LAB_WAIT_CASE(24) LAB_WAIT_CASE(25) LAB_WAIT_CASE(26) LAB_WAIT_CASE(27)
    LAB_WAIT_CASE(28) LAB_WAIT_CASE(29) LAB_WAIT_CASE(30) LAB_WAIT_CASE(31)
#undef LAB_WAIT_CASE
    default:
      cp_async_wait<0>();
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// All threads: copy bytes [a, a + n) of src (an array of `total` bytes) as
// the aligned window covering them into dst; byte a lands at dst + (a & 15).
// The array's last chunk reads only the bytes that exist and zero-fills.
__device__ __forceinline__ void copy_window_async(uint8_t* dst,
                                                  const uint8_t* src,
                                                  int64_t a, int64_t n,
                                                  int64_t total) {
  if (n <= 0) return;
  const int64_t lo = a & ~static_cast<int64_t>(15);
  const int nchunks = static_cast<int>((round16(a + n) - lo) >> 4);
  for (int j = threadIdx.x; j < nchunks; j += THREADS) {
    const int64_t g = lo + 16 * static_cast<int64_t>(j);
    cp_async16(dst + 16 * j, src + g, static_cast<int>(min64(16, total - g)));
  }
}

// ---- mbarrier + TMA bulk copy ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread: the bulk part of the aligned window of bytes [a, a + n) of an
// array of `total` bytes, i.e. [lo, hi) with hi at most total rounded down
// to 16; the bytes [hi, a + n) past it are stored with plain loads here.
// Returns hi - lo, the bytes the caller's bulk copy moves.
__device__ __forceinline__ uint32_t window_plan(uint8_t* dst,
                                                const uint8_t* src, int64_t a,
                                                int64_t n, int64_t total,
                                                int64_t* lo_out) {
  const int64_t lo = a & ~static_cast<int64_t>(15);
  const int64_t hi =
      max64(lo, min64(round16(a + n), total & ~static_cast<int64_t>(15)));
  for (int64_t g = hi; g < a + n; ++g) dst[g - lo] = src[g];
  *lo_out = lo;
  return static_cast<uint32_t>(hi - lo);
}

// ---- shared-memory tables and lane sums -----------------------------------

// The query's M LUT rows and the norm table (as row M), C copies of each
// entry side by side. No barrier: the caller syncs.
template <int C>
__device__ __forceinline__ void stage_luts(float* s_lut,
                                           const float* __restrict__ lut_b,
                                           const float* __restrict__ norm_tab,
                                           int M) {
  const int n = (M + 1) * KSUB;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float v = i < M * KSUB ? lut_b[i] : norm_tab[i - M * KSUB];
    if constexpr (C % 4 == 0) {
      const float4 v4 = make_float4(v, v, v, v);
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        *reinterpret_cast<float4*>(s_lut + i * C + c) = v4;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) s_lut[i * C + c] = v;
    }
  }
}

// A lane's distance from its staged code row, summed as adc_scan.cu's
// lane_sum sums it: bias, norm, then m = 0..M-1. Rows are 16-byte aligned
// at M=16 and 8-byte aligned at M=8.
template <int C>
__device__ __forceinline__ float lut_sum(const float* s_lut,
                                         const uint8_t* row, uint8_t ncode,
                                         float bs, int M, int c) {
  float acc = bs + s_lut[((M << 8) + ncode) * C + c];
  if (M == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(row);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc += s_lut[((((q * 4 + t) << 8) + ((w[q] >> (8 * t)) & 0xff)) * C) +
                     c];
      }
    }
  } else if (M == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(row);
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc += s_lut[((((q * 4 + t) << 8) + ((w[q] >> (8 * t)) & 0xff)) * C) +
                     c];
      }
    }
  } else {
    for (int m = 0; m < M; ++m) acc += s_lut[(((m << 8) + row[m]) * C) + c];
  }
  return acc;
}

// COPY_ONLY's stand-in for the lookups: the row's bytes summed as f32,
// norm first, then m = 0..M-1.
__device__ __forceinline__ float byte_sum(const uint8_t* row, uint8_t ncode,
                                          int M) {
  float acc = static_cast<float>(ncode);
  if (M == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(row);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc += static_cast<float>((w[q] >> (8 * t)) & 0xff);
      }
    }
  } else if (M == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(row);
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc += static_cast<float>((w[q] >> (8 * t)) & 0xff);
      }
    }
  } else {
    for (int m = 0; m < M; ++m) acc += static_cast<float>(row[m]);
  }
  return acc;
}

// One slot from its stage: the wide lanes, or (MIN) this thread's share of
// the slot minimum reduced over the warp into s_red[warp].
template <int GRAN, int C, bool BRANCHLESS, int MODE, int EPI>
__device__ __forceinline__ void process_slot(const float* s_lut,
                                             const uint8_t* stage,
                                             const Args& a, int64_t sb, int s,
                                             float* s_red) {
  const int M = a.M;
  const int ln = min(a.len[sb + s], GRAN);
  const int64_t row0 = MODE == COMPUTE_ONLY ? a.tile_row : a.start[sb + s];
  const float bs = MODE == FULL ? a.bias[sb + s] : 0.0f;
  const uint8_t* crow = stage + ((row0 * M) & 15);
  const uint8_t* nrow = stage + codes_region(GRAN, M) + (row0 & 15);
  const int c = threadIdx.x % C;
  const int lim = (EPI == MIN && !BRANCHLESS) ? ln : GRAN;
  float* o = a.out + (sb + s) * GRAN;
  float best = INFINITY;
  for (int l = threadIdx.x; l < lim; l += THREADS) {
    float v = INFINITY;
    if (BRANCHLESS || l < ln) {
      v = MODE == COPY_ONLY ? byte_sum(crow + l * M, nrow[l], M)
                            : lut_sum<C>(s_lut, crow + l * M, nrow[l], bs, M, c);
      if (BRANCHLESS && l >= ln) v = INFINITY;
    }
    if (EPI == WIDE) {
      o[l] = v;
    } else {
      best = fminf(best, v);
    }
  }
  if (EPI == MIN) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
    }
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = best;
  }
}

// All threads: start the copies of slot s into `stage` (its len rows, or
// with BRANCHLESS a full GRAN rows clipped to the store).
template <int GRAN, bool BRANCHLESS>
__device__ __forceinline__ void issue_slot(uint8_t* stage, const Args& a,
                                           int64_t sb, int s) {
  const int64_t st = a.start[sb + s];
  const int64_t rows = BRANCHLESS ? min64(GRAN, a.N - st)
                                  : min(a.len[sb + s], GRAN);
  copy_window_async(stage, a.codes, st * a.M, rows * a.M, a.N * a.M);
  copy_window_async(stage + codes_region(GRAN, a.M), a.norm_codes, st, rows,
                    a.N);
}

template <int GRAN, int C, int DEPTH, int SPS, bool BATCHED, bool BRANCHLESS,
          int MODE, int EPI>
__global__ void __launch_bounds__(THREADS) lab_pipe_kernel(Args a) {
  static_assert(DEPTH >= SPS, "a step's slots must fit the ring");
  extern __shared__ __align__(128) uint8_t smem[];
  const int M = a.M;
  float* s_lut = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + lut_bytes(M, C);
  const int64_t sbytes = stage_bytes(GRAN, M);
  // The warps' slot minima, double-buffered by step parity so that a step's
  // writes never meet the previous step's reduction.
  float* s_red = reinterpret_cast<float*>(ring + DEPTH * sbytes);
  const int S = a.nslots;
  const int64_t sb = static_cast<int64_t>(blockIdx.x) * S;

  if (MODE != COPY_ONLY) {
    stage_luts<C>(s_lut, a.lut + static_cast<int64_t>(blockIdx.x) * M * KSUB,
                  a.norm_tab, M);
  }
  if (MODE == COMPUTE_ONLY) {
    const int64_t rows = min64(GRAN, a.N - a.tile_row);
    copy_window_async(ring, a.codes, a.tile_row * M, rows * M, a.N * M);
    copy_window_async(ring + codes_region(GRAN, M), a.norm_codes, a.tile_row,
                      rows, a.N);
    cp_async_commit();
    cp_async_wait_all();
  } else {
#pragma unroll 1
    for (int i = 0; i < DEPTH; ++i) {  // one commit group per slot
      if (i < S) issue_slot<GRAN, BRANCHLESS>(ring + i * sbytes, a, sb, i);
      cp_async_commit();
    }
  }
  __syncthreads();

  // Before step `base`, DEPTH + base groups are committed and slot base + i
  // is group base + i, so it has landed once at most DEPTH - 1 - i groups
  // are pending.
#pragma unroll 1
  for (int base = 0; base < S; base += SPS) {
    float* red = s_red + ((base / SPS) & 1) * SPS * NWARPS;
    if (MODE != COMPUTE_ONLY && BATCHED) {
      cp_async_wait<DEPTH - SPS>();
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < SPS; ++i) {
      const int s = base + i;
      if (MODE != COMPUTE_ONLY && !BATCHED) {
        cp_async_wait_n(DEPTH - 1 - i);
        __syncthreads();
      }
      if (MODE == COMPUTE_ONLY) {
        asm volatile("" ::: "memory");  // no lookup hoisted across slots
      }
      if (s < S) {
        process_slot<GRAN, C, BRANCHLESS, MODE, EPI>(
            s_lut, MODE == COMPUTE_ONLY ? ring : ring + (s % DEPTH) * sbytes,
            a, sb, s, red + i * NWARPS);
      }
    }
    __syncthreads();  // the step's stages are free, its minima written
    if (EPI == MIN && threadIdx.x < SPS && base + threadIdx.x < S) {
      float m = INFINITY;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        m = fminf(m, red[threadIdx.x * NWARPS + w]);
      }
      a.out[sb + base + threadIdx.x] = m;
    }
    if (MODE != COMPUTE_ONLY) {
#pragma unroll
      for (int i = 0; i < SPS; ++i) {
        const int s = base + DEPTH + i;
        if (s < S) {
          issue_slot<GRAN, BRANCHLESS>(ring + (s % DEPTH) * sbytes, a, sb, s);
        }
        cp_async_commit();
      }
    }
  }
  cp_async_wait_all();
}

// One thread: slot s's code and norm bytes into `stage` by bulk copies that
// complete on `bar` (a plain arrive for an empty slot).
__device__ __forceinline__ void issue_bulk(uint8_t* stage, uint64_t* bar,
                                           const Args& a, int64_t sb, int s,
                                           int gran) {
  const int64_t st = a.start[sb + s];
  const int64_t rows = min(a.len[sb + s], gran);
  const int M = a.M;
  int64_t clo = 0, nlo = 0;
  uint8_t* ndst = stage + codes_region(gran, M);
  uint32_t cbytes = 0, nbytes = 0;
  if (rows > 0) {
    cbytes = window_plan(stage, a.codes, st * M, rows * M, a.N * M, &clo);
    nbytes = window_plan(ndst, a.norm_codes, st, rows, a.N, &nlo);
  }
  mbar_arrive_expect_tx(bar, cbytes + nbytes);
  if (cbytes) bulk_copy(stage, a.codes + clo, cbytes, bar);
  if (nbytes) bulk_copy(ndst, a.norm_codes + nlo, nbytes, bar);
}

template <int DEPTH>
__global__ void __launch_bounds__(THREADS) lab_runs_kernel(Args a) {
  constexpr int GRAN = 1024;
  extern __shared__ __align__(128) uint8_t smem[];
  const int M = a.M;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* s_lut = reinterpret_cast<float*>(smem + BAR_BYTES);
  uint8_t* ring = smem + BAR_BYTES + lut_bytes(M, 1);
  const int64_t sbytes = stage_bytes(GRAN, M);
  const int S = a.nslots;
  const int64_t sb = static_cast<int64_t>(blockIdx.x) * S;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  stage_luts<1>(s_lut, a.lut + static_cast<int64_t>(blockIdx.x) * M * KSUB,
                a.norm_tab, M);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < DEPTH && i < S; ++i) {
      issue_bulk(ring + i * sbytes, &bars[i], a, sb, i, GRAN);
    }
  }
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const int stg = s % DEPTH;
    mbar_wait(&bars[stg], static_cast<uint32_t>((s / DEPTH) & 1));
    process_slot<GRAN, 1, false, FULL, WIDE>(s_lut, ring + stg * sbytes, a,
                                            sb, s, nullptr);
    __syncthreads();  // the stage is free
    if (threadIdx.x == 0 && s + DEPTH < S) {
      issue_bulk(ring + stg * sbytes, &bars[stg], a, sb, s + DEPTH, GRAN);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Args& a, int B, int smem_floor,
           void* stream, int* info) {
  if (smem_floor > 0 && static_cast<size_t>(smem_floor) > smem) {
    smem = static_cast<size_t>(smem_floor);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (info != nullptr) {
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, THREADS, smem);
    info[0] = blocks;
    info[1] = static_cast<int>(smem);
    return static_cast<int>(e);
  }
  if (B == 0 || a.nslots == 0) return 0;
  kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int GRAN, int C, int DEPTH, int SPS, bool BATCHED, bool BRANCHLESS,
          int MODE, int EPI>
int launch_pipe(const Args& a, int B, int smem_floor, void* stream,
                int* info) {
  const size_t smem = static_cast<size_t>(
      lut_bytes(a.M, C) + DEPTH * stage_bytes(GRAN, a.M) +
      2 * SPS * NWARPS * sizeof(float));
  return launch(
      lab_pipe_kernel<GRAN, C, DEPTH, SPS, BATCHED, BRANCHLESS, MODE, EPI>,
      smem, a, B, smem_floor, stream, info);
}

template <int DEPTH>
int launch_runs(const Args& a, int B, int smem_floor, void* stream,
                int* info) {
  const size_t smem = static_cast<size_t>(BAR_BYTES + lut_bytes(a.M, 1) +
                                          DEPTH * stage_bytes(1024, a.M));
  return launch(lab_runs_kernel<DEPTH>, smem, a, B, smem_floor, stream, info);
}

Args make_args(const void* lut, const void* norm_tab, const void* codes,
               const void* norm_codes, const void* start, const void* len,
               const void* bias, void* out, int nslots, int M, long long N,
               long long tile_row) {
  return Args{static_cast<const float*>(lut),
              static_cast<const float*>(norm_tab),
              static_cast<const uint8_t*>(codes),
              static_cast<const uint8_t*>(norm_codes),
              static_cast<const int64_t*>(start),
              static_cast<const int32_t*>(len),
              static_cast<const float*>(bias),
              static_cast<float*>(out),
              nslots,
              M,
              static_cast<int64_t>(N),
              static_cast<int64_t>(tile_row)};
}

}  // namespace

#define LAB_ARGS                                                            \
  const void *lut, const void *norm_tab, const void *codes,                 \
      const void *norm_codes, const void *start, const void *len,           \
      const void *bias, void *out, int B, int nslots, int M, long long N,   \
      long long tile_row, int smem_floor, void *stream, int *info
#define LAB_MAKE                                                            \
  make_args(lut, norm_tab, codes, norm_codes, start, len, bias, out, nslots, \
            M, N, tile_row)

// Each name below is an entry point of ops/cuda/scan_lab.py's VARIANTS.
#define LAB_PIPE(NAME, GRAN, C, DEPTH, SPS, BATCHED, BRANCHLESS, MODE, EPI) \
  extern "C" int ivf_lab_##NAME(LAB_ARGS) {                                 \
    return launch_pipe<GRAN, C, DEPTH, SPS, BATCHED, BRANCHLESS, MODE,      \
                       EPI>(LAB_MAKE, B, smem_floor, stream, info);         \
  }
#define LAB_RUNS(NAME, DEPTH)                                               \
  extern "C" int ivf_lab_##NAME(LAB_ARGS) {                                 \
    return launch_runs<DEPTH>(LAB_MAKE, B, smem_floor, stream, info);       \
  }

// gran 256: L4's steps x depth, L3's v1b, C copies, and the decomposition.
LAB_PIPE(pipe256_c1_d8_s2, 256, 1, 8, 2, false, false, FULL, WIDE)
LAB_PIPE(pipe256_c1_d16_s4, 256, 1, 16, 4, false, false, FULL, WIDE)
LAB_PIPE(pipe256_c1_d2_s1, 256, 1, 2, 1, false, false, FULL, WIDE)
LAB_PIPE(pipe256_c1_d16_s4_bw, 256, 1, 16, 4, true, false, FULL, WIDE)
LAB_PIPE(pipe256_c8_d8_s2, 256, 8, 8, 2, false, false, FULL, WIDE)
LAB_PIPE(pipe256_c1_d8_s2_min, 256, 1, 8, 2, false, false, FULL, MIN)
LAB_PIPE(pipe256_c8_d8_s2_min, 256, 8, 8, 2, false, false, FULL, MIN)
LAB_PIPE(comp256_wide, 256, 1, 8, 2, false, false, COMPUTE_ONLY, WIDE)
LAB_PIPE(comp256_min, 256, 1, 8, 2, false, false, COMPUTE_ONLY, MIN)
LAB_PIPE(copy256_wide, 256, 1, 8, 2, false, false, COPY_ONLY, WIDE)
LAB_PIPE(copy256_min, 256, 1, 8, 2, false, false, COPY_ONLY, MIN)
// gran 1024: L2's C copies, branchless and depth, and the decomposition;
// L1's bulk-copy runs.
LAB_PIPE(pipe1024_c1_d2_s1, 1024, 1, 2, 1, false, false, FULL, WIDE)
LAB_PIPE(pipe1024_c4_d2_s1, 1024, 4, 2, 1, false, false, FULL, WIDE)
LAB_PIPE(pipe1024_c8_d2_s1, 1024, 8, 2, 1, false, false, FULL, WIDE)
LAB_PIPE(pipe1024_c1_d2_s1_nb, 1024, 1, 2, 1, false, true, FULL, WIDE)
LAB_PIPE(pipe1024_c1_d4_s2, 1024, 1, 4, 2, false, false, FULL, WIDE)
LAB_PIPE(pipe1024_c1_d2_s1_min, 1024, 1, 2, 1, false, false, FULL, MIN)
LAB_PIPE(pipe1024_c8_d2_s1_min, 1024, 8, 2, 1, false, false, FULL, MIN)
LAB_PIPE(comp1024_wide, 1024, 1, 2, 1, false, false, COMPUTE_ONLY, WIDE)
LAB_PIPE(comp1024_min, 1024, 1, 2, 1, false, false, COMPUTE_ONLY, MIN)
LAB_PIPE(copy1024_wide, 1024, 1, 2, 1, false, false, COPY_ONLY, WIDE)
LAB_PIPE(copy1024_min, 1024, 1, 2, 1, false, false, COPY_ONLY, MIN)
LAB_RUNS(runs1024_d2, 2)
LAB_RUNS(runs1024_d4, 4)
