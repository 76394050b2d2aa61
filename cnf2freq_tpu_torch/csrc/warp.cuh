// Warp-wide helpers for kernels that hold one 64-state row per warp
// (lane l: states l and l + 32): csrc/fb_classic.cu, csrc/fb_ext.cu and
// csrc/coherence.cu.
#pragma once

#include <cuda_runtime.h>

namespace cnf {

constexpr unsigned kFullMask = 0xffffffffu;

// the sum over the warp, the same value in every lane
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// unnormalised 64-point Walsh-Hadamard transform of the warp's row: the
// stride-32 stage inside the thread, strides 16..1 by __shfl_xor_sync
template <typename T>
__device__ __forceinline__ void fwht64(T& lo, T& hi, int lane) {
  const T a = lo + hi, b = lo - hi;
  lo = a;
  hi = b;
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    const T olo = __shfl_xor_sync(kFullMask, lo, h);
    const T ohi = __shfl_xor_sync(kFullMask, hi, h);
    const bool upper = (lane & h) != 0;
    lo = upper ? olo - lo : lo + olo;
    hi = upper ? ohi - hi : hi + ohi;
  }
}

}  // namespace cnf
