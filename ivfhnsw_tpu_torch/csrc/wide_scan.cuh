// The ADC wide scan (K1/K2 of the JAX package, see adc_scan.cu) as one
// kernel body with its design steps as template switches. adc_scan.cu
// instantiates the production kernels from it; scan_lab.cu instantiates
// every step as a kernel of its own (ops/cuda/scan_lab.py::WIDE_STEPS), so
// that tools/wide_probe.py can time each against the first port
// (scan_lab.cu::direct_wide_kernel) on one card and count its machine
// instructions. The lookup itself is min_scan.cuh's (code_value, the table
// staging), so the wide lanes and the min kernel's minima add the same
// terms in the same order. Only the switches of the steps that are kept
// (the way to production, its split, its rivals) are here; PERF.md holds
// the readings of the others (four lanes a thread, bulk stores of
// shared-memory tiles, persistent blocks, early fills of empty slots,
// 16-byte tail stores).
//
// Every FULL step computes, bit for bit, what the first port computes:
//
//   out[b, s*gran + l] = bias[b,s] + norm_tab[norm_codes[r]]
//                        + sum_m lut[b,m,codes[r,m]]   if l < len[b,s]
//                      = +inf                          otherwise
//   (r = start[b,s] + l; summed in that order in f32)
//
// One block of THREADS threads per query; the query's M x 256 LUT and the
// norm table are staged in shared memory once.
//
// The switches (each is one step of tools/wide_probe.py):
//   ADDR    min_scan.cuh's: SHIFT (the first port's shift, mask and
//           multiply-add) or DP4A (one IDP.4A a lookup).
//   WARP    false: the first port's structure, all THREADS threads on one
//           slot at a time (thread t owns lanes t, t + THREADS, ...), so
//           every slot costs the block one dependent chain len -> start ->
//           code row -> lookups -> store. true: warp w owns slots w,
//           w + NWARPS, ...; its lanes stride the slot, so NWARPS slots'
//           chains are in flight a block and a slot's fields are loaded
//           once for gran lanes.
//   STAGE   min_scan.cuh's staging: LOOP (the first port's) or TMA.
//   OUT     PLAIN: the first port's stores, every lane of an empty slot
//           included. STREAM: st.global.cs stores (the output passes L2
//           once), and an empty slot is 16-byte +inf stores (a run of
//           them, in the block layout, one fill by the whole block).
//   MODE    FULL, the function above. The split of a step's time:
//           STORES: no code reads, no lookups, bias in each valid lane;
//           NOOUT: the full loop, each thread's lanes folded into one
//           register by fminf and one store a thread into out [B, THREADS]
//           (thread t's column); COMPUTE: each lane l looks up the
//           constant store row l mod 32, its words xor'ed with (l & zero)
//           (zero a lab kernel's argument that is 0: the compiler cannot
//           hoist the lookups), output written; LOADS: the code reads
//           without the lookups, each valid lane holding
//           (w0 ^ w1 ^ w2 ^ w3 ^ norm_code) & 0xffffff as f32.
//   BINS    (FULL only; the production kernels' second instantiation)
//           also bins[b, s*gran/32 + j] = min of lanes 32j .. 32j+31 of
//           the slot, the minima the bin-32 top-k selects bins by. Both
//           layouts give one warp 32 consecutive lanes of a slot at a time
//           (lane x of a warp a slot, thread t + 256i of a block a slot),
//           so a bin is one warp's values of one step: folded by a
//           __shfl_xor_sync tree of fminf and stored by lane 0, with the
//           lanes' policy; an empty slot's bins are +inf. Needs gran % 32
//           == 0. The lanes are never NaN, so the minima equal an amin over
//           the stored lanes bit for bit.
// COMPUTE and LOADS need 16-byte code rows (M = 16 on a 16-byte aligned
// store).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "min_scan.cuh"
#include "scan_common.cuh"

namespace wide_scan {

using min_scan::KSUB;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int FULL = 0, STORES = 1, NOOUT = 2, COMPUTE = 3, LOADS = 4;
constexpr int OUT_PLAIN = 0, OUT_STREAM = 1;

struct Params {
  const float* lut;           // [B, M, 256]
  const float* norm_tab;      // [256]
  const uint8_t* codes;       // [N, M]
  const uint8_t* norm_codes;  // [N]
  const int64_t* start;       // [B, S]
  const int32_t* len;         // [B, S]
  const float* bias;          // [B, S]
  float* out;                 // [B, S*gran] ([B, THREADS] for NOOUT)
  int nslots;
  int M;
  int gran;
  int vec16;                  // M == 16 and codes 16-byte aligned
  float* bins = nullptr;      // [B, S*gran/32] (BINS)
};

// ---- one lane --------------------------------------------------------------

// What a thread carries from slot to slot.
struct Lane {
  const float* s_lut;
  const float* s_norm;
  uint4 c0;                // COMPUTE: the constant row and its norm code
  uint32_t n0;
  uint32_t zero;
  int lane;
  float fold;              // NOOUT: the minimum of this thread's lanes
};

// Lane l (< the slot's length) of a slot whose rows start at cb / nb: V16,
// a 16-byte code row (p.vec16), else the byte loop of any M.
template <int ADDR, int MODE, bool V16>
__device__ __forceinline__ float lane_value(const Params& p, const Lane& x,
                                            const uint8_t* cb,
                                            const uint8_t* nb, uint32_t l,
                                            float bs) {
  if (MODE == STORES) return bs;
  if (!V16) {
    return min_scan::generic_value(x.s_lut, x.s_norm,
                                   cb + static_cast<uint64_t>(l) * p.M, nb[l],
                                   bs, p.M);
  }
  uint4 c;
  uint32_t n;
  if (MODE == COMPUTE) {
    c = x.c0;
    n = x.n0;
    min_scan::perturb(c, n, static_cast<int>(l), x.zero);
  } else {
    c = __ldg(reinterpret_cast<const uint4*>(cb + static_cast<uint64_t>(l) *
                                                      16));
    n = __ldg(nb + l);
  }
  return min_scan::code_value<ADDR, MODE == LOADS ? min_scan::LOADS
                                                  : min_scan::FULL>(
      x.s_lut, x.s_norm, c, n, bs);
}

template <int OUT>
__device__ __forceinline__ void put(float* o, float v) {
  if (OUT == OUT_PLAIN) {
    *o = v;
  } else {
    __stcs(o, v);
  }
}

// Lane l's value v to o + l, or folded into the thread's minimum.
template <int OUT, int MODE>
__device__ __forceinline__ void emit(Lane& x, float* o, int l, float v) {
  if (MODE == NOOUT) {
    x.fold = fminf(x.fold, v);
  } else {
    put<OUT>(o + l, v);
  }
}

// ---- one query ----------------------------------------------------------------

// Every slot of query b, the query's tables staged.
template <int ADDR, bool WARP, int OUT, int MODE, bool V16, bool BINS>
__device__ __forceinline__ void query(const Params& p, Lane& x, int64_t b) {
  const int gran = p.gran, S = p.nslots, M = p.M;
  const int gb = gran >> 5;  // bins a slot (BINS)
  const int64_t sb = b * S;
  float* out_b = p.out + sb * gran;
  float* bins_b = BINS ? p.bins + sb * gb : nullptr;
  if (WARP) {
    for (int s = threadIdx.x >> 5; s < S; s += NWARPS) {
      const int ln = min(p.len[sb + s], gran);  // warp-uniform
      float* o = out_b + static_cast<int64_t>(s) * gran;
      float* ob = bins_b + static_cast<int64_t>(s) * gb;
      if (ln <= 0) {
        if (MODE == NOOUT) continue;
        if (BINS) {
          for (int j = x.lane; j < gb; j += 32) put<OUT>(ob + j, INFINITY);
        }
        if (OUT == OUT_STREAM && (gran & 3) == 0) {
          const float4 inf4 =
              make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
          for (int i = 4 * x.lane; i < gran; i += 128) {
            __stcs(reinterpret_cast<float4*>(o + i), inf4);
          }
        } else {
          for (int i = x.lane; i < gran; i += 32) put<OUT>(o + i, INFINITY);
        }
        continue;
      }
      const int64_t st = p.start[sb + s];
      const float bs = p.bias[sb + s];
      const uint8_t* cb = p.codes + st * M;
      const uint8_t* nb = p.norm_codes + st;
      for (int l = x.lane; l < gran; l += 32) {
        const float v =
            l < ln ? lane_value<ADDR, MODE, V16>(p, x, cb, nb, l, bs)
                   : INFINITY;
        emit<OUT, MODE>(x, o, l, v);
        if (BINS) scan_common::store_bin<OUT == OUT_STREAM>(ob, l, v);
      }
    }
  } else {
    for (int s = 0; s < S; ++s) {
      const int ln = p.len[sb + s];
      float* o = out_b + static_cast<int64_t>(s) * gran;
      float* ob = bins_b + static_cast<int64_t>(s) * gb;
      if (ln <= 0 && MODE == NOOUT) continue;
      if (ln <= 0 && OUT == OUT_STREAM) {  // this and the empty ones after
        int e = s + 1;
        while (e < S && p.len[sb + e] <= 0) ++e;
        scan_common::fill_inf(o, static_cast<int64_t>(e - s) * gran);
        if (BINS) scan_common::fill_inf(ob, static_cast<int64_t>(e - s) * gb);
        s = e - 1;
        continue;
      }
      const int64_t st = p.start[sb + s];
      const float bs = p.bias[sb + s];
      const uint8_t* cb = p.codes + st * M;
      const uint8_t* nb = p.norm_codes + st;
      for (int l = threadIdx.x; l < gran; l += THREADS) {
        const float v =
            l < ln ? lane_value<ADDR, MODE, V16>(p, x, cb, nb, l, bs)
                   : INFINITY;
        emit<OUT, MODE>(x, o, l, v);
        if (BINS) scan_common::store_bin<OUT == OUT_STREAM>(ob, l, v);
      }
    }
  }
  if (MODE == NOOUT) p.out[b * THREADS + threadIdx.x] = x.fold;
}

// ---- the kernel body --------------------------------------------------------

// The kernel body at one setting of the switches; zero is 0 (COMPUTE's
// perturbation mask: the production kernels pass the constant).
template <int ADDR, bool WARP, int STAGE, int OUT, int MODE, bool BINS = false>
__device__ __forceinline__ void body(const Params& p, uint32_t zero) {
  static_assert(!BINS || MODE == FULL, "bin minima of the full scan only");
  const int M = p.M;
  const int64_t b = blockIdx.x;
  float* s_lut = min_scan::min_scan_smem;
  float* s_norm = s_lut + M * KSUB;
  min_scan::stage<STAGE>(s_lut, s_norm, p.lut + b * M * KSUB, p.norm_tab, M,
                         reinterpret_cast<uint64_t*>(s_norm + KSUB));
  Lane x;
  x.s_lut = s_lut;
  x.s_norm = s_norm;
  x.lane = threadIdx.x & 31;
  x.zero = zero;
  x.fold = INFINITY;
  x.c0 = make_uint4(0u, 0u, 0u, 0u);
  x.n0 = 0;
  if (MODE == COMPUTE) {
    x.c0 = __ldg(reinterpret_cast<const uint4*>(p.codes) + x.lane);
    x.n0 = __ldg(p.norm_codes + x.lane);
  }
  // each code path a loop of its own
  if (p.vec16) {
    query<ADDR, WARP, OUT, MODE, true, BINS>(p, x, b);
  } else {
    query<ADDR, WARP, OUT, MODE, false, BINS>(p, x, b);
  }
}

}  // namespace wide_scan
