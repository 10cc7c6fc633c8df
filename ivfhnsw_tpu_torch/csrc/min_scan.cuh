// The ADC min scan (K3/K4 of the JAX package, see adc_scan.cu) as one
// kernel body with its design steps as template switches. adc_scan.cu
// instantiates the production kernel from it; scan_lab.cu instantiates
// every step as a kernel of its own (ops/cuda/scan_lab.py::MIN_STEPS), so
// that tools/min_probe.py can time each against the first port
// (scan_lab.cu::direct_min_kernel) on one card and count its machine
// instructions. Only the switches of the steps that are kept (the way to
// production, its split, an open lead) are here; PERF.md holds the
// readings of the others.
//
// Every FULL step computes, bit for bit, what the first port computes:
//
//   mins[b, s] = min over l < min(len[b,s], gran) of
//                bias[b,s] + norm_tab[norm_codes[r]] + sum_m lut[b,m,codes[r,m]]
//                (r = start[b,s] + l; summed in that order in f32)
//              = +inf when len[b,s] == 0
//
// One block of THREADS threads per query; the query's M x 256 LUT and the
// norm table are staged in shared memory once (row M = the norm table).
//
// The switches (each is one step of tools/min_probe.py):
//   ADDR   how a lookup's shared-memory address comes from its code byte.
//          SHIFT: the first port's shift and mask, then the compiler's
//          multiply-add of the table's base. PRMT: the byte by one
//          __byte_perm and the LUT read as one shared-memory array, so each
//          row's offset is an immediate of the load (ptxas still adds the
//          base with one LEA: LDS takes no scaled index). DP4A: one IDP.4A,
//          __dp4a(word, 4 << 8t, base) = base + 4 * byte t, then LDS at the
//          row's immediate offset: three instructions a lookup (IDP.4A,
//          LDS, FADD).
//   OFF32  per slot one 64-bit pointer to its first code row and norm
//          code; a lane's row is that pointer plus a 32-bit offset.
//   CPS    codes per lane per step. 1: the first port's loop (a lane stops
//          at its own last code). 2: a warp-uniform loop whose steps
//          take two codes a lane, so two independent add chains; lanes past
//          the slot's end read its last row again (a duplicate cannot
//          change a minimum), so there is no tail loop and no per-lane
//          predicate, a code of the last step that lies wholly past the end
//          is skipped by a warp-uniform test, and the slot's len, start and
//          bias are loaded together.
//   PF     (stepped loop only) the next step's rows are loaded before this
//          step's lookups, so a warp's code reads are in flight while it
//          computes.
//   STAGE  LOOP: the first port's staging (one 4-byte load and store a
//          thread per iteration, then __syncthreads); VEC: 16-byte loads,
//          all issued before the stores; TMA: one bulk copy for the LUT and
//          one for the norm table onto an mbarrier.
//   MODE   FULL, the function above; COMPUTE, no code loads in the lane
//          loop: each lane loads row min(lane, len - 1) of the slot once
//          and looks it up at every step, its words xor'ed with (lane index
//          & zero), zero a lab kernel's second argument that is 0, so that
//          the compiler cannot hoist the lookups out of the loop (five ALU
//          operations a code more than FULL); the result is the minimum of
//          the slot's first 32 lanes. LOADS, no lookups: each lane loads
//          its rows and keeps the minimum of (w0 ^ w1 ^ w2 ^ w3 ^
//          norm_code) & 0xffffff over its 16-byte row words, as f32.
// COMPUTE and LOADS exist to take a step's time apart (PERF.md); they need
// 16-byte code rows (M = 16 on a 16-byte aligned store).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace min_scan {

constexpr int KSUB = 256;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int FULL = 0, COMPUTE = 1, LOADS = 2;
constexpr int STAGE_LOOP = 0, STAGE_VEC = 1, STAGE_TMA = 2;
constexpr int ADDR_SHIFT = 0, ADDR_PRMT = 1, ADDR_DP4A = 2;

struct Params {
  const float* lut;           // [B, M, 256]
  const float* norm_tab;      // [256]
  const uint8_t* codes;       // [N, M]
  const uint8_t* norm_codes;  // [N]
  const int64_t* start;       // [B, S]
  const int32_t* len;         // [B, S]
  const float* bias;          // [B, S]
  float* mins;                // [B, S]
  int nslots;
  int M;
  int gran;
  int vec16;                  // M == 16 and codes 16-byte aligned
};

// Dynamic shared memory of a launch: the tables and an mbarrier.
__host__ __device__ __forceinline__ size_t smem_bytes(int M) {
  return static_cast<size_t>(M + 1) * KSUB * sizeof(float) + 16;
}

extern __shared__ __align__(16) float min_scan_smem[];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- staging ---------------------------------------------------------------

__device__ __forceinline__ void stage_loop(float* s_lut, float* s_norm,
                                           const float* __restrict__ lut_b,
                                           const float* __restrict__ norm_tab,
                                           int M) {
  for (int i = threadIdx.x; i < M * KSUB; i += blockDim.x) s_lut[i] = lut_b[i];
  for (int i = threadIdx.x; i < KSUB; i += blockDim.x) s_norm[i] = norm_tab[i];
}

// 16-byte loads, four a thread in flight before their stores (the whole
// table at M = 16), the norm table's 64 with the first four.
__device__ __forceinline__ void stage_vec(float* s_lut, float* s_norm,
                                          const float* __restrict__ lut_b,
                                          const float* __restrict__ norm_tab,
                                          int M) {
  const float4* src = reinterpret_cast<const float4*>(lut_b);
  float4* dst = reinterpret_cast<float4*>(s_lut);
  const int n4 = M * KSUB / 4;
  const int t = threadIdx.x;
  const float4 nv = t < KSUB / 4
                        ? __ldg(reinterpret_cast<const float4*>(norm_tab) + t)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = t; i0 < n4; i0 += 4 * THREADS) {
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j * THREADS < n4) v[j] = __ldg(src + i0 + j * THREADS);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j * THREADS < n4) dst[i0 + j * THREADS] = v[j];
    }
  }
  if (t < KSUB / 4) reinterpret_cast<float4*>(s_norm)[t] = nv;
}

__device__ __forceinline__ void stage_tma(float* s_lut, float* s_norm,
                                          const float* lut_b,
                                          const float* norm_tab, int M,
                                          uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t lut_bytes = static_cast<uint32_t>(M) * KSUB * 4;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(lut_bytes + KSUB * 4)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(s_lut)),
        "l"(lut_b), "r"(lut_bytes), "r"(b)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(s_norm)),
        "l"(norm_tab), "r"(KSUB * 4), "r"(b)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

// The tables in shared memory, visible to every thread on return. VEC and
// TMA need 16-byte aligned tables and take the first port's loop when
// they are not (a block-uniform branch).
template <int STAGE>
__device__ __forceinline__ void stage(float* s_lut, float* s_norm,
                                      const float* __restrict__ lut_b,
                                      const float* __restrict__ norm_tab,
                                      int M, uint64_t* bar) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(lut_b) |
                         reinterpret_cast<uintptr_t>(norm_tab)) & 15u) == 0;
  if (STAGE == STAGE_TMA && aligned) {
    stage_tma(s_lut, s_norm, lut_b, norm_tab, M, bar);
    return;
  }
  if (STAGE == STAGE_VEC && aligned) {
    stage_vec(s_lut, s_norm, lut_b, norm_tab, M);
  } else {
    stage_loop(s_lut, s_norm, lut_b, norm_tab, M);
  }
  __syncthreads();
}

// ---- one code ----------------------------------------------------------------

// One 4-byte shared-memory load at 32-bit shared address a + OFF.
template <int OFF>
__device__ __forceinline__ float lds_at(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n" : "=f"(v) : "r"(a), "n"(OFF));
  return v;
}

// acc + LUT row m at byte t of w (= code byte m = 4q + t), DP4A addressing
// from the table's shared address base.
template <int Q, int T>
__device__ __forceinline__ float add_dp4a(float acc, uint32_t w,
                                          uint32_t base) {
  return acc + lds_at<(Q * 4 + T) * KSUB * 4>(
                   __dp4a(w, 4u << (8 * T), base));
}

template <int Q>
__device__ __forceinline__ float add_word_dp4a(float acc, uint32_t w,
                                               uint32_t base) {
  acc = add_dp4a<Q, 0>(acc, w, base);
  acc = add_dp4a<Q, 1>(acc, w, base);
  acc = add_dp4a<Q, 2>(acc, w, base);
  return add_dp4a<Q, 3>(acc, w, base);
}

// acc + the 16 LUT rows at the code bytes of c, in the order m = 0..15.
template <int ADDR>
__device__ __forceinline__ float sum16(const float* s_lut, uint4 c,
                                       float acc) {
  if (ADDR == ADDR_DP4A) {
    const uint32_t base = smem_u32(s_lut);
    acc = add_word_dp4a<0>(acc, c.x, base);
    acc = add_word_dp4a<1>(acc, c.y, base);
    acc = add_word_dp4a<2>(acc, c.z, base);
    return add_word_dp4a<3>(acc, c.w, base);
  }
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t k = ADDR == ADDR_PRMT ? __byte_perm(w[q], 0, 0x4440 + t)
                                           : ((w[q] >> (8 * t)) & 0xffu);
      acc += s_lut[(q * 4 + t) * KSUB + k];
    }
  }
  return acc;
}

// The value a lane keeps the minimum of, for a 16-byte code row c and its
// norm code n (zero-extended).
template <int ADDR, int MODE>
__device__ __forceinline__ float code_value(const float* s_lut,
                                            const float* s_norm, uint4 c,
                                            uint32_t n, float bs) {
  if (MODE == LOADS) {
    return __uint2float_rn((c.x ^ c.y ^ c.z ^ c.w ^ n) & 0xffffffu);
  }
  const float nv = ADDR == ADDR_DP4A ? lds_at<0>(smem_u32(s_norm) + 4 * n)
                                     : s_norm[n];
  return sum16<ADDR>(s_lut, c, bs + nv);
}

// COMPUTE's row at lane index l: the words and norm code xor'ed with
// l & zero (zero is 0: the same row, in registers the compiler cannot
// prove constant across l).
__device__ __forceinline__ void perturb(uint4& c, uint32_t& n, int l,
                                        uint32_t zero) {
  const uint32_t z = static_cast<uint32_t>(l) & zero;
  c.x ^= z;
  c.y ^= z;
  c.z ^= z;
  c.w ^= z;
  n ^= z;
}

// Any M, any alignment: the first port's byte loop.
__device__ __forceinline__ float generic_value(const float* s_lut,
                                               const float* s_norm,
                                               const uint8_t* __restrict__ c,
                                               uint8_t n, float bs, int M) {
  float acc = bs + s_norm[n];
  for (int m = 0; m < M; ++m) acc += s_lut[m * KSUB + c[m]];
  return acc;
}

// ---- the kernel body --------------------------------------------------------

// The rows of lane indices base + 32 j + lane (j < CPS) of a slot of ln
// codes, clamped to its last row; COMPUTE keeps the lane's own row.
template <int CPS, int MODE>
__device__ __forceinline__ void load_step(uint4 (&c)[CPS], uint32_t (&n)[CPS],
                                          const uint8_t* cb,
                                          const uint8_t* nb, int base,
                                          int lane, int ln, uint4 c0,
                                          uint32_t n0, uint32_t zero) {
#pragma unroll
  for (int j = 0; j < CPS; ++j) {
    if (MODE == COMPUTE) {
      c[j] = c0;
      n[j] = n0;
      perturb(c[j], n[j], base + j * 32, zero);
    } else {
      const uint32_t r =
          static_cast<uint32_t>(min(base + j * 32 + lane, ln - 1));
      c[j] = __ldg(reinterpret_cast<const uint4*>(
          cb + static_cast<uint64_t>(r) * 16));
      n[j] = __ldg(nb + r);
    }
  }
}

// The kernel body at one setting of the switches; zero is 0 (COMPUTE's
// perturbation mask: the production kernels pass the constant).
template <int ADDR, bool OFF32, int CPS, int STAGE, bool PF, int MODE>
__device__ __forceinline__ void body(const Params& p, uint32_t zero) {
  static_assert(CPS == 1 || CPS == 2, "one or two codes a lane a step");
  static_assert(CPS == 1 || OFF32, "the stepped loop takes 32-bit offsets");
  static_assert(CPS > 1 || !PF, "prefetch is a switch of the stepped loop");
  const int M = p.M;
  float* s_lut = min_scan_smem;
  float* s_norm = s_lut + M * KSUB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_norm + KSUB);

  const int64_t b = blockIdx.x;
  stage<STAGE>(s_lut, s_norm, p.lut + b * M * KSUB, p.norm_tab, M, bar);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t sb = b * p.nslots;
  const int gran = p.gran;
  for (int s = warp; s < p.nslots; s += NWARPS) {
    float best = INFINITY;
    if (CPS == 1) {
      // the first port's loop: fields after the length, each lane to its
      // own last code
      const int ln = min(p.len[sb + s], gran);   // warp-uniform
      if (ln > 0) {
        const int64_t st = p.start[sb + s];
        const float bs = p.bias[sb + s];
        const uint8_t* cb = p.codes + st * M;
        const uint8_t* nb = p.norm_codes + st;
        if (p.vec16 && MODE == COMPUTE) {
          const int r = min(lane, ln - 1);
          const uint4 c0 = __ldg(reinterpret_cast<const uint4*>(cb) + r);
          const uint32_t n0 = __ldg(nb + r);
          for (int l = lane; l < ln; l += 32) {
            uint4 c = c0;
            uint32_t n = n0;
            perturb(c, n, l - lane, zero);
            best = fminf(best, code_value<ADDR, FULL>(s_lut, s_norm, c, n,
                                                      bs));
          }
        } else if (p.vec16) {
          for (int l = lane; l < ln; l += 32) {
            uint4 c;
            uint32_t n;
            if (OFF32) {
              c = __ldg(reinterpret_cast<const uint4*>(
                  cb + static_cast<uint64_t>(static_cast<uint32_t>(l)) * 16));
              n = __ldg(nb + static_cast<uint32_t>(l));
            } else {
              const int64_t r = st + l;
              c = __ldg(reinterpret_cast<const uint4*>(p.codes + r * 16));
              n = __ldg(p.norm_codes + r);
            }
            best = fminf(best, code_value<ADDR, MODE>(s_lut, s_norm, c, n,
                                                      bs));
          }
        } else {
          for (int l = lane; l < ln; l += 32) {
            const int64_t r = st + l;
            best = fminf(best, generic_value(s_lut, s_norm, p.codes + r * M,
                                             p.norm_codes[r], bs, M));
          }
        }
      }
    } else {
      // the stepped loop: the three fields together, CPS codes a lane a
      // step, lanes past the end on the slot's last row
      const int ln = min(p.len[sb + s], gran);
      const int64_t st = p.start[sb + s];
      const float bs = p.bias[sb + s];
      if (ln > 0) {
        const uint8_t* cb = p.codes + st * M;
        const uint8_t* nb = p.norm_codes + st;
        if (p.vec16) {
          constexpr int STEP = 32 * CPS;
          uint4 c0 = make_uint4(0u, 0u, 0u, 0u);
          uint32_t n0 = 0;
          if (MODE == COMPUTE) {
            const int r = min(lane, ln - 1);
            c0 = __ldg(reinterpret_cast<const uint4*>(cb) + r);
            n0 = __ldg(nb + r);
          }
          uint4 c[CPS];
          uint32_t n[CPS];
          if (PF) {
            load_step<CPS, MODE>(c, n, cb, nb, 0, lane, ln, c0, n0, zero);
          }
          for (int base = 0; base < ln; base += STEP) {
            uint4 cn[CPS];
            uint32_t nn[CPS];
            // PF: the next step's rows (the slot's last row past its end)
            // before this step's lookups; else this step's
            if constexpr (PF) {
              load_step<CPS, MODE>(cn, nn, cb, nb, base + STEP, lane, ln, c0,
                                   n0, zero);
            } else {
              load_step<CPS, MODE>(c, n, cb, nb, base, lane, ln, c0, n0,
                                   zero);
            }
#pragma unroll
            for (int j = 0; j < CPS; ++j) {
              // a code whose lanes all lie past the slot's end is skipped
              // whole (a warp-uniform test)
              if (j == 0 || base + j * 32 < ln) {
                best = fminf(best, code_value<ADDR, MODE>(s_lut, s_norm,
                                                          c[j], n[j], bs));
              }
            }
            if (PF) {
#pragma unroll
              for (int j = 0; j < CPS; ++j) {
                c[j] = cn[j];
                n[j] = nn[j];
              }
            }
          }
        } else {
          for (int l = lane; l < ln; l += 32) {
            best = fminf(best, generic_value(s_lut, s_norm, cb + l * M, nb[l],
                                             bs, M));
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      best = fminf(best, __shfl_xor_sync(0xffffffffu, best, o));
    }
    if (lane == 0) p.mins[sb + s] = best;
  }
}

}  // namespace min_scan
