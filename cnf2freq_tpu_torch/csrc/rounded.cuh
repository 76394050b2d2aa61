// Arithmetic rounded after every operation, as PyTorch's elementwise
// kernels round it: one kernel launch per operation, so a product is
// rounded before it is added.  nvcc contracts a * b + c into one fused
// multiply-add (rounded once) unless told otherwise, and the plain
// PyTorch twins of the update kernels (csrc/capped.cu, csrc/relskew.cu)
// decide on their values (a bisection step, a cap at 1 - eps): written
// with these, a kernel takes the twin's roundings, operation for
// operation.  The intrinsics are never contracted.
#pragma once

#include <cuda_runtime.h>

namespace cnf {
namespace rn {

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div(double a, double b) {
  return __ddiv_rn(a, b);
}
// torch.log: logf in float, log in double
__device__ __forceinline__ float ln(float a) { return logf(a); }
__device__ __forceinline__ double ln(double a) { return ::log(a); }

// torch.maximum / torch.minimum: NaN if either operand is NaN
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

}  // namespace rn
}  // namespace cnf
