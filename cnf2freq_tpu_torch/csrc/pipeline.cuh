// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), for the sweeps that stage their inputs a
// tile of markers ahead of the dependent chain (csrc/fb_small.cu, and the
// interval rows of csrc/fb_ext.cu's carry-only entry).
//
// A tile's copies are one commit group.  A ring of NT tiles keeps NT - 1
// groups in flight: before tile t is read, wait_groups<NT - 2>() waits
// for this thread's copies of tile t, and a __syncthreads() then makes
// every thread's copies visible and frees the slot that tile t - 1 held,
// into which the copies of tile t + NT - 1 go.  Every thread commits one
// group a tile, empty or not, so the counts stay uniform.
#pragma once

#include <cuda_runtime.h>

namespace cnf {

// 16 bytes from global `src` into shared `dst`, both 16-byte aligned
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cnf
