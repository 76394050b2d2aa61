// The relative-skew smoothing HMM's ratio: per individual row of one
// chromosome, the posterior of phase state 1 at every marker, from a
// 2-state forward pass (emission at m, then transition relhaplo[m]) and an
// emission-inclusive backward pass.
//
// A kernel for an XLA program of the JAX package, not for a Pallas
// kernel: cnf2freq_tpu/updates/relskew.py::relskew_ratio, whose two
// lax.scans (forward at :50, backward at :66) the TPU ran inside the
// jitted update.  The port's plain twin, updates/relskew.py::
// relskew_ratio_reference, is a Python loop over the markers of about 10
// launches a marker and direction.
//   cnf_relskew_ratio_*   hw, rh [N, Mc] read in place through a row
//                         stride (the columns lo:hi of the cohort's
//                         [N, M] tensors); ratio [N, Mc]; fw [Mc, N, 2]
//                         scratch for the forward states.
// The renormalisation is the twin's: a state pair is multiplied by 1e20
// only when its mass is below 1e-10, else left as it is.  The arithmetic
// is the twin's, rounded after every operation (rounded.cuh).
//
// Bound on the H100: bytes, hw and rh read once and the ratio written
// once (2.3 MB in float32 at 1000 x 192, under a microsecond).  One
// thread owns a row and runs its 2 x Mc dependent steps, so a launch
// lasts one row's chain: 1000 rows fill 32 warps, fewer than the card's
// SMs, and the kernel is latency-bound.  Blocks of one warp spread the
// rows over as many SMs as there are warps.  The forward states go to
// [Mc, N, 2] so that a warp's stores at one marker are one run.
#include <cuda_runtime.h>

#include "rounded.cuh"

namespace {

using namespace cnf::rn;

constexpr int kThreads = 32;

// mass below 1e-10: scale by 1e20 (relskew._renorm)
template <typename T>
__device__ __forceinline__ void renorm(T& s0, T& s1) {
  if (add(s0, s1) < T(1e-10)) {
    s0 = mul(s0, T(1e20));
    s1 = mul(s1, T(1e20));
  }
}

// s * (r, 1 - r) + flip(s) * (1 - r, r)  (relskew._trans)
template <typename T>
__device__ __forceinline__ void trans(T& s0, T& s1, T r) {
  const T nb = sub(T(1), r);
  const T t0 = add(mul(s0, r), mul(s1, nb));
  const T t1 = add(mul(s1, r), mul(s0, nb));
  s0 = t0;
  s1 = t1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    relskew_kernel(const T* __restrict__ hw, const T* __restrict__ rh,
                   T* __restrict__ fw, T* __restrict__ ratio, int N, int M,
                   int hw_stride, int rh_stride) {
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    const T* h = hw + (long long)n * hw_stride;
    const T* r = rh + (long long)n * rh_stride;
    T* out = ratio + (long long)n * M;
    T s0 = T(0.5), s1 = T(0.5);
    for (int m = 0; m < M; ++m) {
      const T e1 = h[m];
      s0 = mul(s0, sub(T(1), e1));
      s1 = mul(s1, e1);
      T* f = fw + ((long long)m * N + n) * 2;
      f[0] = s0;
      f[1] = s1;
      renorm(s0, s1);
      trans(s0, s1, r[m]);
    }
    {
      const T* f = fw + ((long long)(M - 1) * N + n) * 2;
      out[M - 1] = div(f[1], add(f[0], f[1]));
    }
    s0 = T(0.5);
    s1 = T(0.5);
    for (int m = M - 2; m >= 0; --m) {
      const T e1 = h[m + 1];
      s0 = mul(s0, sub(T(1), e1));
      s1 = mul(s1, e1);
      trans(s0, s1, r[m]);
      renorm(s0, s1);
      const T* f = fw + ((long long)m * N + n) * 2;
      const T q0 = mul(s0, f[0]), q1 = mul(s1, f[1]);
      out[m] = div(q1, add(q0, q1));
    }
  }
}

template <typename T>
int launch_relskew(const T* hw, const T* rh, T* fw, T* ratio, int N, int M,
                   int hw_stride, int rh_stride, void* stream) {
  if (N < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || M == 0) return 0;
  const int grid = (N + kThreads - 1) / kThreads;
  relskew_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      hw, rh, fw, ratio, N, M, hw_stride, rh_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cnf_relskew_ratio_f32(const float* hw, const float* rh, float* fw,
                          float* ratio, int N, int M, int hw_stride,
                          int rh_stride, void* stream) {
  return launch_relskew<float>(hw, rh, fw, ratio, N, M, hw_stride,
                               rh_stride, stream);
}

int cnf_relskew_ratio_f64(const double* hw, const double* rh, double* fw,
                          double* ratio, int N, int M, int hw_stride,
                          int rh_stride, void* stream) {
  return launch_relskew<double>(hw, rh, fw, ratio, N, M, hw_stride,
                                rh_stride, stream);
}

}  // extern "C"
