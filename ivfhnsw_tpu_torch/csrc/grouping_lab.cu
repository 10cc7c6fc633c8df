// The grouping scan lab: the steps of grouping_scan.cuh's kernel template
// from the kernel as first ported ("direct": every lane through the lane
// loop, default-policy stores, pruned lanes summed in full, the schedule
// read in place) to the engine's kernel and one step past it, bound to
// Python with ctypes (ivfhnsw_tpu_torch/ops/cuda/grouping_lab.py).
// tools/grouping_probe.py holds each to torch.equal with the plain version
// and times them in turns. Every variant computes the function of the TPU
// kernels K5 / K6 (ivfhnsw_tpu/ops/pallas/grouping_scan.py:113, :248).

#include "grouping_scan.cuh"

// `variant` as in ops/cuda/grouping_lab.py::VARIANTS. Returns 0, the CUDA
// error code of the launch, or cudaErrorInvalidValue for an unknown variant.
extern "C" int ivf_grouping_lab(
    const void* lut, const void* norm_tab, const void* t2, const void* codes,
    const void* norm_codes, const void* subc, const void* start,
    const void* len, const void* bias, const void* seg, void* out, int B,
    int nslots, int M, int gran, int P, int nsubc, int variant,
    void* stream) {
  using grouping_scan::launch;
#define LAB_CASE(id, FILL, STREAM, SKIP, STAGE, BULK)                        \
  case id:                                                                   \
    return launch<FILL, STREAM, SKIP, STAGE, BULK>(                          \
        lut, norm_tab, t2, codes, norm_codes, subc, start, len, bias, seg,   \
        out, B, nslots, M, gran, P, nsubc, stream);
  switch (variant) {
    LAB_CASE(0, false, false, false, false, false)  // direct
    LAB_CASE(1, true, false, false, false, false)   // fill
    LAB_CASE(2, true, true, false, false, false)    // fill_stream
    LAB_CASE(3, true, true, true, false, false)     // fill_stream_skip
    LAB_CASE(4, true, true, true, true, false)      // staged
    LAB_CASE(5, false, false, true, false, false)   // skip
    LAB_CASE(6, true, true, true, false, true)      // bulk
    case 7:  // overlap: the two-pass kernel
      return grouping_scan::launch_overlap(lut, norm_tab, t2, codes,
                                           norm_codes, subc, start, len, bias,
                                           seg, out, B, nslots, M, gran, P,
                                           nsubc, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAB_CASE
}
