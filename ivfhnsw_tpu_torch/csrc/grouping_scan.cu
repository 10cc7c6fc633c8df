// The Grouping(+Pruning) scan kernel that the search engine runs, bound to
// Python with ctypes (ivfhnsw_tpu_torch/ops/cuda/grouping_scan.py::
// grouping_scan_slots). It replaces the TPU kernels K5 and K6
// (ivfhnsw_tpu/ops/pallas/grouping_scan.py:113 _grouping_kernel, :248
// _grouping_kernel_quad). The function, what bounds it on an H100 and the
// design are set out in grouping_scan.cuh, whose kernel template this file
// instantiates with padding filled outside the lane loop, streaming stores
// and the pruned-lane shortcut, and with the schedule read in place; twice,
// the second also writing the bin-32 minima of the output to bins when the
// caller passes it (not null).

#include "grouping_scan.cuh"

// The engine's instantiation, without and with the bin minima.
template <bool BINS>
constexpr auto* engine =
    &grouping_scan::launch</*FILL=*/true, /*STREAM=*/true, /*SKIP=*/true,
                           /*STAGE=*/false, /*BULK=*/false, BINS>;

extern "C" int ivf_grouping_scan_slots(
    const void* lut, const void* norm_tab, const void* t2, const void* codes,
    const void* norm_codes, const void* subc, const void* start,
    const void* len, const void* bias, const void* seg, void* out, void* bins,
    int B, int nslots, int M, int gran, int P, int nsubc, void* stream) {
  return (bins != nullptr ? engine<true> : engine<false>)(
      lut, norm_tab, t2, codes, norm_codes, subc, start, len, bias, seg, out,
      B, nslots, M, gran, P, nsubc, stream, bins);
}
