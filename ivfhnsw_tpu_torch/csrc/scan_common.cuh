// Device helpers shared by the scan kernels of this directory (adc_scan.cu,
// grouping_scan.cuh). ops/cuda/build.py hashes every header
// here into each library's name, so an edit rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace scan_common {

// One store of the scan output: streaming (st.global.cs: the wide output
// passes through L2 once and should not evict the code store) or, with
// STREAM off, the default policy.
template <bool STREAM = true, typename T>
__device__ __forceinline__ void store_out(T* p, T v) {
  if (STREAM) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// All threads of the block: n floats of +inf at o, by 16-byte stores where
// o and n allow, else one float a store.
template <bool STREAM = true>
__device__ __forceinline__ void fill_inf(float* o, int64_t n) {
  if (((reinterpret_cast<uintptr_t>(o) | static_cast<uintptr_t>(n * 4)) &
       15u) == 0) {
    const float4 inf4 = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int64_t i = threadIdx.x; i < n / 4; i += blockDim.x) {
      store_out<STREAM, float4>(o4 + i, inf4);
    }
  } else {
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      store_out<STREAM, float>(o + i, INFINITY);
    }
  }
}

}  // namespace scan_common
