// Device helpers shared by the scan kernels of this directory (adc_scan.cu,
// wide_scan.cuh, grouping_scan.cuh). ops/cuda/build.py hashes every header
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

// One bin of the scan output's bin-32 minima: the calling warp's 32 lanes
// hold lanes l & ~31 .. l | 31 of a row (all 32 call, each with its lane l
// and value v); their minimum, folded by a __shfl_xor_sync tree of fminf,
// goes to ob[l / 32], stored by lane 0.
template <bool STREAM = true>
__device__ __forceinline__ void store_bin(float* ob, int l, float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  if ((threadIdx.x & 31) == 0) store_out<STREAM, float>(ob + (l >> 5), v);
}

}  // namespace scan_common
