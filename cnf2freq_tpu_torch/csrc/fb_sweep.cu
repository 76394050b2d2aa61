// Forward and backward sweeps along the markers of one chromosome.
//
// Replaces the TPU kernels cnf2freq_tpu/ops/scan_v2.py::_fbv2_fwd_kernel
// and ::_fbv2_bwd_kernel (launcher fb_sweeps_v2_pallas).  Per (unit r,
// shift n) the 64-state carry steps through the markers:
//   clip values below 1e-300 (0 in f32, so only negative rounding
//   residue is clipped there), multiply by e, renormalise per shift with
//   log-factor accumulation (MINFACTOR when the sum is 0), then apply the
//   xor transition FWHT64 . diag(lam) . FWHT64 / 64.
// The backward sweep seeds ones / zero factors at the last marker and
// uses lam row m-1 when stepping from marker m to m-1.
//
// Bound on the H100: memory.  Per marker a thread reads 64 emissions and
// writes 64 values of each stored sweep tensor (fw_pre, fw_post, bw: ~1.6
// GB at M=192, R=1024 in f32, plus 2 reads of e); the 2 x 6 x 32
// butterflies per step are cheap.  The marker axis is sequential, so the
// parallelism is R x 8 threads.  Design: one thread per (unit, shift)
// keeps its carry in registers across the whole marker loop (the TPU kept
// it in VMEM across a sequential grid axis), the FWHT runs as unrolled
// register butterflies, normalisation is per shift so no reduction
// crosses threads, and the 32 threads of a warp are 32 consecutive units
// of one shift, so every load and store is coalesced over r.
#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void fwht64(T (&p)[64]) {
#pragma unroll
  for (int h = 1; h < 64; h <<= 1)
#pragma unroll
    for (int i = 0; i < 64; i += 2 * h)
#pragma unroll
      for (int j = i; j < i + h; ++j) {
        const T a = p[j], b = p[j + h];
        p[j] = a + b;
        p[j + h] = a - b;
      }
}

// the adjustprobs zero clip 1e-300, as the type holds it: 0 in float,
// where only negative rounding residue is clipped
template <typename T>
struct Clip;
template <>
struct Clip<float> {
  static constexpr float v = 0.0f;
};
template <>
struct Clip<double> {
  static constexpr double v = 1e-300;
};

// adjustprobs: clip, multiply by e, renormalise; p in place, f updated
template <typename T>
__device__ __forceinline__ void emit_norm(T (&p)[64], T& f, const T* e,
                                          size_t stride) {
  const T clip = Clip<T>::v;
  T s = T(0);
#pragma unroll
  for (int g = 0; g < 64; ++g) {
    const T q = (p[g] < clip ? T(0) : p[g]) * e[g * stride];
    p[g] = q;
    s += q;
  }
  if (s > T(0)) {
#pragma unroll
    for (int g = 0; g < 64; ++g) p[g] = p[g] / s;
    f = f + log(s);
  } else {
#pragma unroll
    for (int g = 0; g < 64; ++g) p[g] = T(0);
    f = T(cnf::kMinFactor);
  }
}

template <typename T>
__device__ __forceinline__ void transition(T (&p)[64], const T* lam) {
  fwht64(p);
#pragma unroll
  for (int g = 0; g < 64; ++g) p[g] *= lam[g];
  fwht64(p);
#pragma unroll
  for (int g = 0; g < 64; ++g) p[g] *= T(1.0 / 64.0);
}

template <typename T>
__global__ void fwd_kernel(const T* __restrict__ e, const T* __restrict__ lam,
                           T evengen, T* __restrict__ fw_pre,
                           T* __restrict__ fw_post, T* __restrict__ fw_pre_f,
                           T* __restrict__ fw_post_f, int M, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (r >= R) return;
  const size_t stride = R;
  T p[64];
#pragma unroll
  for (int g = 0; g < 64; ++g) p[g] = evengen;
  T f = T(0);
  for (int m = 0; m < M; ++m) {
    const size_t base = ((size_t)m * 512 + n * 64) * stride + r;
    const size_t fi = ((size_t)m * 8 + n) * stride + r;
#pragma unroll
    for (int g = 0; g < 64; ++g) fw_pre[base + g * stride] = p[g];
    fw_pre_f[fi] = f;
    emit_norm(p, f, e + base, stride);
#pragma unroll
    for (int g = 0; g < 64; ++g) fw_post[base + g * stride] = p[g];
    fw_post_f[fi] = f;
    transition(p, lam + (size_t)m * 64);
  }
}

template <typename T>
__global__ void bwd_kernel(const T* __restrict__ e, const T* __restrict__ lam,
                           T* __restrict__ bw, T* __restrict__ bw_f, int M,
                           int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (r >= R) return;
  const size_t stride = R;
  T p[64];
#pragma unroll
  for (int g = 0; g < 64; ++g) p[g] = T(1);
  T f = T(0);
  for (int m = M - 1; m >= 0; --m) {
    const size_t base = ((size_t)m * 512 + n * 64) * stride + r;
#pragma unroll
    for (int g = 0; g < 64; ++g) bw[base + g * stride] = p[g];
    bw_f[((size_t)m * 8 + n) * stride + r] = f;
    if (m > 0) {
      emit_norm(p, f, e + base, stride);
      transition(p, lam + (size_t)(m - 1) * 64);
    }
  }
}

template <typename T>
int launch_fb(const T* e, const T* lam, T evengen, T* fw_pre, T* fw_post,
              T* bw, T* fw_pre_f, T* fw_post_f, T* bw_f, int M, int R,
              void* stream) {
  if (M <= 0 || R <= 0) return 0;
  // one warp per block: R/32 x 8 blocks spread over every SM
  const dim3 block(32);
  const dim3 grid((R + 31) / 32, 8);
  cudaStream_t s = (cudaStream_t)stream;
  fwd_kernel<T><<<grid, block, 0, s>>>(e, lam, evengen, fw_pre, fw_post,
                                       fw_pre_f, fw_post_f, M, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<T><<<grid, block, 0, s>>>(e, lam, bw, bw_f, M, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cnf_fb_sweep_f32(const float* e, const float* lam, float evengen,
                     float* fw_pre, float* fw_post, float* bw,
                     float* fw_pre_f, float* fw_post_f, float* bw_f, int M,
                     int R, void* stream) {
  return launch_fb<float>(e, lam, evengen, fw_pre, fw_post, bw, fw_pre_f,
                          fw_post_f, bw_f, M, R, stream);
}

int cnf_fb_sweep_f64(const double* e, const double* lam, double evengen,
                     double* fw_pre, double* fw_post, double* bw,
                     double* fw_pre_f, double* fw_post_f, double* bw_f, int M,
                     int R, void* stream) {
  return launch_fb<double>(e, lam, evengen, fw_pre, fw_post, bw, fw_pre_f,
                           fw_post_f, bw_f, M, R, stream);
}

}  // extern "C"
