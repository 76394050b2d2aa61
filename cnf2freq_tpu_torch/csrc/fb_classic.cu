// Forward and backward sweeps in the [B, M, NS, S] layout (state minor).
//
// Replaces the TPU kernels cnf2freq_tpu/ops/fb_pallas.py::_fwd_kernel and
// ::_bwd_kernel (launcher fb_sweeps_pallas), which the coherence-carrying
// scan runs.  Per (unit b, shift ns) the 64-state carry steps through the
// markers exactly as the TPU kernels do:
//   clip values below 1e-30, multiply by e, renormalise with log-factor
//   accumulation (MINFACTOR when the sum is 0), then apply the xor
//   transition H . diag(lam) . H / 64.
// The forward carry starts at 1/64 and stores fw_pre (before the
// emission) and fw_post (after it); the backward carry starts at ones,
// stores bw at each marker m and steps to m-1 with lam row m-1.
//
// Bound on the H100: memory.  Per marker a warp reads one 64-value row
// of e and writes three stored rows (fw_pre, fw_post, bw: with e read
// twice, ~2 GB at B=1000, M=192 in f32); the butterflies are cheap.  The
// TPU multiplied [TB*NS, 64] row blocks by a 64x64 Hadamard matrix on the
// MXU.  Here the 64 states of one (unit, shift) are contiguous, so one
// warp owns a row: lane l holds states l and l+32, the renormalising sum
// is a warp reduction, the FWHT's stride-32 stage runs inside the thread
// and strides 16..1 by __shfl_xor_sync, the carry stays in registers
// across the marker loop, and every load and store is one coalesced
// 64-value row.  Forward and backward sweeps are independent and run as
// the two halves of one grid (gridDim.y == 2), so B*8*2 warps are in
// flight.  The next marker's e row is loaded before the current step's
// arithmetic, hiding part of its latency.
#include <cuda_runtime.h>

#include "blocks.cuh"
#include "warp.cuh"

namespace {

constexpr int kWarps = 4;
// clip, emit, renormalise (adjustprobs with the TPU kernel's 1e-30 clip)
template <typename T>
__device__ __forceinline__ void emit_norm(T& lo, T& hi, T& f, T elo, T ehi) {
  const T clip = T(1e-30);
  lo = (lo < clip ? T(0) : lo) * elo;
  hi = (hi < clip ? T(0) : hi) * ehi;
  const T s = cnf::warp_sum(lo + hi);  // the same value in every lane
  if (s > T(0)) {
    lo = lo / s;
    hi = hi / s;
    f = f + log(s);
  } else {
    lo = T(0);
    hi = T(0);
    f = T(cnf::kMinFactor);
  }
}

template <typename T>
__device__ __forceinline__ void transition(T& lo, T& hi, const T* lam,
                                           int lane) {
  cnf::fwht64(lo, hi, lane);
  lo *= lam[lane];
  hi *= lam[lane + 32];
  cnf::fwht64(lo, hi, lane);
  lo *= T(1.0 / 64.0);
  hi *= T(1.0 / 64.0);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    fb_classic_kernel(const T* __restrict__ e, const T* __restrict__ lam,
                      T* __restrict__ fw_pre, T* __restrict__ fw_post,
                      T* __restrict__ bw, T* __restrict__ fw_pre_f,
                      T* __restrict__ fw_post_f, T* __restrict__ bw_f, int B,
                      int M) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)B * 8) return;
  const int b = (int)(row >> 3), ns = (int)(row & 7);
  // element (b, m, ns, lane) is base + m * 512; factor (b, m, ns) is
  // fbase + m * 8
  const size_t base = ((size_t)b * M * 8 + ns) * 64 + lane;
  const size_t fbase = (size_t)b * M * 8 + ns;

  if (blockIdx.y == 0) {
    T lo = T(1.0 / 64.0), hi = T(1.0 / 64.0), f = T(0);
    T elo = e[base], ehi = e[base + 32];
    for (int m = 0; m < M; ++m) {
      const size_t i = base + (size_t)m * 512;
      T nlo = T(0), nhi = T(0);
      if (m + 1 < M) {
        nlo = e[i + 512];
        nhi = e[i + 512 + 32];
      }
      fw_pre[i] = lo;
      fw_pre[i + 32] = hi;
      if (lane == 0) fw_pre_f[fbase + (size_t)m * 8] = f;
      emit_norm(lo, hi, f, elo, ehi);
      fw_post[i] = lo;
      fw_post[i + 32] = hi;
      if (lane == 0) fw_post_f[fbase + (size_t)m * 8] = f;
      transition(lo, hi, lam + (size_t)m * 64, lane);
      elo = nlo;
      ehi = nhi;
    }
  } else {
    T lo = T(1), hi = T(1), f = T(0);
    const size_t last = base + (size_t)(M - 1) * 512;
    T elo = e[last], ehi = e[last + 32];
    for (int m = M - 1; m >= 0; --m) {
      const size_t i = base + (size_t)m * 512;
      bw[i] = lo;
      bw[i + 32] = hi;
      if (lane == 0) bw_f[fbase + (size_t)m * 8] = f;
      if (m > 0) {
        const T nlo = e[i - 512], nhi = e[i - 512 + 32];
        emit_norm(lo, hi, f, elo, ehi);
        transition(lo, hi, lam + (size_t)(m - 1) * 64, lane);
        elo = nlo;
        ehi = nhi;
      }
    }
  }
}

template <typename T>
int launch_fb_classic(const T* e, const T* lam, T* fw_pre, T* fw_post, T* bw,
                      T* fw_pre_f, T* fw_post_f, T* bw_f, int B, int M,
                      void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const long long rows = (long long)B * 8;
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps), 2);
  fb_classic_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      e, lam, fw_pre, fw_post, bw, fw_pre_f, fw_post_f, bw_f, B, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cnf_fb_classic_f32(const float* e, const float* lam, float* fw_pre,
                       float* fw_post, float* bw, float* fw_pre_f,
                       float* fw_post_f, float* bw_f, int B, int M,
                       void* stream) {
  return launch_fb_classic<float>(e, lam, fw_pre, fw_post, bw, fw_pre_f,
                                  fw_post_f, bw_f, B, M, stream);
}

int cnf_fb_classic_f64(const double* e, const double* lam, double* fw_pre,
                       double* fw_post, double* bw, double* fw_pre_f,
                       double* fw_post_f, double* bw_f, int B, int M,
                       void* stream) {
  return launch_fb_classic<double>(e, lam, fw_pre, fw_post, bw, fw_pre_f,
                                   fw_post_f, bw_f, B, M, stream);
}

}  // extern "C"
