// Fused ADC posting-list scans for Hopper (sm_90a), bound to Python with
// ctypes (ivfhnsw_tpu_torch/ops/cuda/adc_scan.py::adc_scan_slots and
// ::adc_scan_slots_min). Two kernels over one per-lane sum, added in one
// order (their bodies are wide_scan.cuh's and min_scan.cuh's, the lookup
// shared).
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
//    (bias, norm, m = 0..M-1: lane_sum below and min_scan.cuh's sum16 add
//    the same terms in the same order, in f32), so
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
// in the shared-memory LUT. All lanes of a warp read one LUT row at 32
// codes, and a warp instruction takes one shared-memory wavefront for each
// distinct word in its fullest bank (bank = code mod 32). Both stage the
// query's 17 KB of tables once (B * 17 KB read, 143 MB at B=8192).
//   wide: it also writes 4 B for EVERY lane of the padded [B, nslots*gran]
//         output, empty and tail lanes included; that output is its byte
//         bound (663 MB of 838 at the main path's 256-code slots, B=8192).
//         Measured with tools/wide_probe.py on the main path's schedule
//         (NVIDIA H100 80GB HBM3 at 700 W; PERF.md), the first port's
//         time at 256 was set by its structure, all 256 threads stepping
//         through one slot at a time (len -> start -> code row -> 17
//         lookups -> store, then the next slot): its loop without the
//         output took 0.89x of it, its stores alone 0.63x (3x the card's
//         fill_ of the same bytes), its conflict-free store 0.98x. At 1024
//         the output sets it: the stores alone take 0.87x, the fill_ floor
//         0.6x. With a warp a slot, the loop without the output takes 0.74x
//         of the first port at 256 and the kernel 0.82x.
//   min:  it writes 4 B per slot, so its byte bound (the LUTs and the
//         touched store rows) is a tenth of its time. Measured with
//         tools/min_probe.py on the main path's schedule (B=8192; NVIDIA
//         H100 80GB HBM3 at 700 W; PERF.md): the store's codes cost 1.75
//         wavefronts a lookup (2.70 on the SIFT-like corpus), a floor of
//         0.314 ms (0.462) where conflict-free lookups would take 0.179;
//         the first port's lookups alone, with no code read in its loop,
//         take 0.88x of its 0.47-0.50 ms, its code reads alone 0.55-0.57x.
//         So the conflicts bound it, not the loads, the staging or the
//         issue rate: its loop was 94 SASS instructions a warp and code,
//         and cutting it to 61.5-70 speeds the kernel by about a tenth on
//         a conflict-free store but by 2-5% on real ones. The conflicts go
//         only with a lane-dependent summation order (the bank-skewed LUT
//         of scan_lab.cu), and the order is fixed: the minima equal the
//         wide kernel's slot minima bit for bit.
//
// What the design does about it. One thread block per query stages that
// query's M x 256 LUT and the norm table in shared memory once (17 KB at
// M=16), so LUT bytes come from device memory once per query; reloading
// them per 256-code slot would read ~4x more LUT bytes than code bytes. At
// M=16 a lane's code is one 16-byte load. Slot bases are 64-bit (start*M
// passes 2^31 at ~134M codes), a lane's row a 32-bit offset from it.
//   wide: wide_scan.cuh's body at two settings of its switches, chosen by
//         slot width, each the one that won in turns against the first
//         port at its width and lost on no schedule with a resolved
//         reading. Below 1024 codes (step "warp"): each warp takes slots
//         warp, warp+nwarps, ..., so eight slots' chains are in flight a
//         block and a slot's len, start and bias are loaded once for its
//         lanes, which stride the slot; 84 SASS instructions a warp and
//         code against the first port's 92. At 1024 (step "dp4a"), where
//         the output bounds the kernel, the first port's block a slot,
//         whose threads write each slot's 4 KB together: the warp layout
//         ran 1.01-1.03x of the first port there on schedules over stores
//         larger than L2. Both: a lookup is min_scan.cuh's one IDP.4A; the
//         tables arrive by TMA on an mbarrier; stores stream through L2
//         once (st.global.cs); an empty slot is 16-byte +inf stores (a run
//         of them, in the block layout); 32 registers, 8 blocks per SM as
//         the first port. Four lanes a thread with 16-byte stores (82
//         registers, 2 blocks an SM), bulk stores of shared-memory tiles,
//         persistent blocks, empty slots filled while the tables arrive
//         and 16-byte tail stores were no faster; the first port's body is
//         scan_lab.cu's direct_wide_kernel.
//   min:  min_scan.cuh's body at one setting of its switches, the one
//         of its steps that was faster than the first port in turns at
//         both widths on the main path and slower on no schedule measured:
//         each warp takes slots warp, warp+nwarps, ...; its lanes stride
//         the slot's codes from a 64-bit slot base by 32-bit offsets, each
//         lane to its own last code; a lookup is one IDP.4A (__dp4a(word,
//         4 << 8t, base) is the entry's shared address), the LDS at the
//         row's immediate offset and the FADD; the tables arrive by two TMA
//         bulk copies on an mbarrier. 61.5 SASS instructions per warp and
//         code against the first port's 94 (ptxas unrolls the loop by
//         two), 32 registers, 8 blocks per SM as the first port (a
//         1024-query batch is one wave). A __shfl_xor_sync tree reduces
//         the warp and lane 0 stores one float; no atomics, and an empty
//         slot costs one +inf store. Two codes a lane a step (70
//         instructions) ran as fast on the main path but 1.14x of the
//         first port on a sparse schedule over a store larger than L2; the
//         first port's body is scan_lab.cu's direct_min_kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "min_scan.cuh"
#include "scan_common.cuh"
#include "wide_scan.cuh"

namespace {

// The production wide scan: wide_scan.cuh's body at the setting of its
// switches that measured fastest at each slot width (tools/wide_probe.py,
// PERF.md): a warp a slot below WARP_GRAN_BELOW codes (step "warp"), the
// first port's block a slot at and above it (step "dp4a"), where the
// output bounds the kernel. Both stream their stores and take one IDP.4A
// a lookup and TMA staging.
constexpr int WARP_GRAN_BELOW = 1024;
__global__ void __launch_bounds__(wide_scan::THREADS, 8)
adc_scan_slots_kernel_warp(wide_scan::Params p) {
  wide_scan::body<min_scan::ADDR_DP4A, true, min_scan::STAGE_TMA,
                  wide_scan::OUT_STREAM, wide_scan::FULL>(p, 0u);
}
__global__ void __launch_bounds__(wide_scan::THREADS, 8)
adc_scan_slots_kernel_block(wide_scan::Params p) {
  wide_scan::body<min_scan::ADDR_DP4A, false, min_scan::STAGE_TMA,
                  wide_scan::OUT_STREAM, wide_scan::FULL>(p, 0u);
}

// The production min scan: min_scan.cuh's body at the setting of its
// switches that measured fastest (tools/min_probe.py, PERF.md).
__global__ void __launch_bounds__(min_scan::THREADS, 8)
adc_scan_slots_min_kernel(min_scan::Params p) {
  min_scan::body<min_scan::ADDR_DP4A, true, 1, min_scan::STAGE_TMA, false,
                 min_scan::FULL>(p, 0u);
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
  auto* kernel = gran < WARP_GRAN_BELOW ? adc_scan_slots_kernel_warp
                                        : adc_scan_slots_kernel_block;
  const size_t smem = min_scan::smem_bytes(M);
  if (const int e = set_smem(kernel, smem)) return e;
  const wide_scan::Params p{static_cast<const float*>(lut),
                            static_cast<const float*>(norm_tab),
                            static_cast<const uint8_t*>(codes),
                            static_cast<const uint8_t*>(norm_codes),
                            static_cast<const int64_t*>(start),
                            static_cast<const int32_t*>(len),
                            static_cast<const float*>(bias),
                            static_cast<float*>(out),
                            nslots,
                            M,
                            gran,
                            use_vec16(M, codes)};
  kernel<<<B, wide_scan::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
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
  const size_t smem = min_scan::smem_bytes(M);
  if (const int e = set_smem(adc_scan_slots_min_kernel, smem)) return e;
  const min_scan::Params p{static_cast<const float*>(lut),
                           static_cast<const float*>(norm_tab),
                           static_cast<const uint8_t*>(codes),
                           static_cast<const uint8_t*>(norm_codes),
                           static_cast<const int64_t*>(start),
                           static_cast<const int32_t*>(len),
                           static_cast<const float*>(bias),
                           static_cast<float*>(mins),
                           nslots,
                           M,
                           gran,
                           use_vec16(M, codes)};
  adc_scan_slots_min_kernel<<<B, min_scan::THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
