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
// Boundary carries (the marker-blocked scan, fb_sweeps_v2_pallas's
// lam_pad / init_fwd / init_bwd): the eigenvalue rows come in directly,
// and optional seeds replace evengen / ones / zero factors (a null pointer
// keeps the default).  A carry-only launch (one direction, passes A and B
// of the blocked scan) stores no [M, 512, R] tensor and writes only the
// outgoing carry: the forward (p, f) after the last marker's transition
// (lam row M-1 crosses the block boundary), or the backward one after the
// step at marker 0 through lam_below, the interval below the block.
// It reads e once and stores nothing large (bound 0.162 ms at K=256,
// R=1024 in f32); it took 0.466 ms a launch there, a third of the full
// sweep's 1.400 ms with boundary carries (NVIDIA H100 80GB HBM3,
// 700.00 W): the stores and the second direction, not the chain alone,
// set the full sweep's time.
//
// Bound on the H100: memory in principle (e read by both sweeps, fw_pre,
// fw_post and bw written: ~1.6 GB at M=192, R=1024 in f32), but the
// marker axis is sequential, so what limits a launch is how many
// (unit, shift) chains are in flight and how long one marker step takes:
// R x 8 chains per sweep, a chain of dependent loads, a sum, divides, a
// log and two FWHTs per step.  Design: K lanes share one chain (Lanes<T>
// below); lane q holds states q*(64/K) + j in registers across the whole
// marker loop.  FWHT strides below 64/K stay in the lane, strides from
// 64/K up go through __shfl_xor_sync on the lane bits of q; the
// renormalising sum is the lane's partial sum plus log2 K xor-shuffles,
// so every lane of a chain holds the same s and takes the same branch.
// A warp covers 32/K consecutive units of one shift, so for a fixed j
// one load or store touches K rows x 32/K units: whole 32-byte sectors
// for K <= 4 in f32 and K <= 8 in f64.  Forward and backward sweeps are
// the two halves of one grid (blockIdx.z), both in flight together, and
// the next marker's e slice is loaded before the current step's
// arithmetic.  The division stays IEEE (no reciprocal, no fast math).
//
// Kept K, from a variant run at M=192, R=1024 (K = 1, 2, 4, 8, 32 timed
// in turns; NVIDIA H100 80GB HBM3, 700.00 W): K = 4 in float, 0.914 ms a
// launch, 80 registers; K = 8 in double, 2.114 ms, 108 registers; no
// local memory in either.  Sector fill decides first (float K = 8 took
// 3.5 ms, K = 32 9.7 ms), then one wave of blocks (double K = 4, at 162
// registers, fits 3 blocks an SM: 4.6 ms).  The one-thread-per-chain body
// this replaced took 3.739 ms (float) and 7.142 ms (double) on the same
// card, its 64 carries in local memory.
#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

constexpr int kThreads = 128;

// lanes per (unit, shift) chain, kept per type
template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int k = 4;
};
template <>
struct Lanes<double> {
  static constexpr int k = 8;
};

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

// the K lanes of this lane's chain (aligned groups of K lanes)
template <int K>
__device__ __forceinline__ unsigned chain_mask(int lane) {
  static_assert(K > 0 && K < 32 && (K & (K - 1)) == 0,
                "K: a power of two below 32");
  return ((1u << K) - 1u) << (lane & ~(K - 1));
}

// unnormalised FWHT64 over the chain: strides 1..P/2 in the lane, strides
// P..32 across the lanes q ^ (h / P)
template <typename T, int K>
__device__ __forceinline__ void fwht64(T (&p)[64 / K], int q,
                                       unsigned mask) {
  constexpr int P = 64 / K;
#pragma unroll
  for (int h = 1; h < P; h <<= 1)
#pragma unroll
    for (int i = 0; i < P; i += 2 * h)
#pragma unroll
      for (int j = i; j < i + h; ++j) {
        const T a = p[j], b = p[j + h];
        p[j] = a + b;
        p[j + h] = a - b;
      }
#pragma unroll
  for (int b = 1; b < K; b <<= 1) {
    const bool upper = (q & b) != 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T o = __shfl_xor_sync(mask, p[j], b);
      p[j] = upper ? o - p[j] : p[j] + o;
    }
  }
}

// adjustprobs: clip, multiply by e, renormalise; p in place, f updated.
// The xor-butterfly sum gives every lane of the chain the same s.
template <typename T, int K>
__device__ __forceinline__ void emit_norm(T (&p)[64 / K], T& f,
                                          const T (&e)[64 / K],
                                          unsigned mask) {
  constexpr int P = 64 / K;
  const T clip = Clip<T>::v;
  T s = T(0);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const T v = (p[j] < clip ? T(0) : p[j]) * e[j];
    p[j] = v;
    s += v;
  }
#pragma unroll
  for (int o = 1; o < K; o <<= 1) s += __shfl_xor_sync(mask, s, o);
  if (s > T(0)) {
#pragma unroll
    for (int j = 0; j < P; ++j) p[j] = p[j] / s;
    f = f + log(s);
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) p[j] = T(0);
    f = T(cnf::kMinFactor);
  }
}

template <typename T, int K>
__device__ __forceinline__ void transition(T (&p)[64 / K],
                                           const T (&lam)[64 / K], int q,
                                           unsigned mask) {
  constexpr int P = 64 / K;
  fwht64<T, K>(p, q, mask);
#pragma unroll
  for (int j = 0; j < P; ++j) p[j] *= lam[j];
  fwht64<T, K>(p, q, mask);
#pragma unroll
  for (int j = 0; j < P; ++j) p[j] *= T(1.0 / 64.0);
}

// the lane's P values of row block `at` (stride R) into v
template <typename T, int K>
__device__ __forceinline__ void load_rows(T (&v)[64 / K],
                                          const T* __restrict__ at,
                                          size_t stride) {
#pragma unroll
  for (int j = 0; j < 64 / K; ++j) v[j] = at[j * stride];
}

template <typename T, int K>
__device__ __forceinline__ void store_rows(T* __restrict__ at,
                                           const T (&v)[64 / K],
                                           size_t stride) {
#pragma unroll
  for (int j = 0; j < 64 / K; ++j) at[j * stride] = v[j];
}

template <typename T, int K>
__device__ __forceinline__ void load_lam(T (&v)[64 / K],
                                         const T* __restrict__ row) {
#pragma unroll
  for (int j = 0; j < 64 / K; ++j) v[j] = __ldg(row + j);
}

template <typename T, int K, bool Store>
__global__ void __launch_bounds__(kThreads)
    fb_sweep_kernel(const T* __restrict__ e, const T* __restrict__ lam,
                    const T* __restrict__ lam_below, T evengen,
                    const T* __restrict__ p_fwd, const T* __restrict__ f_fwd,
                    const T* __restrict__ p_bwd, const T* __restrict__ f_bwd,
                    T* __restrict__ fw_pre, T* __restrict__ fw_post,
                    T* __restrict__ bw, T* __restrict__ fw_pre_f,
                    T* __restrict__ fw_post_f, T* __restrict__ bw_f,
                    T* __restrict__ p_out, T* __restrict__ f_out, int M,
                    int R, int dir0) {
  constexpr int P = 64 / K;
  const int q = threadIdx.x & (K - 1);
  const int r = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (r >= R) return;  // the chain's K lanes share r, so all leave
  const unsigned mask = chain_mask<K>(threadIdx.x & 31);
  const size_t stride = R;
  const size_t mstep = (size_t)512 * stride;
  // element (m, n*64 + q*P + j, r) is base + m*mstep + j*stride (a carry
  // [512, R] is one marker of that layout); factor (m, n, r) is
  // fbase + m*fstep
  const size_t base = ((size_t)blockIdx.y * 64 + q * P) * stride + r;
  const size_t fbase = (size_t)blockIdx.y * stride + r;
  const size_t fstep = (size_t)8 * stride;
  const T* lamq = lam + q * P;
  T p[P], ec[P], en[P], lr[P];
  T f = T(0);

  if (dir0 + (int)blockIdx.z == 0) {
    if (p_fwd != nullptr) {
      load_rows<T, K>(p, p_fwd + base, stride);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) p[j] = evengen;
    }
    if (f_fwd != nullptr) f = f_fwd[fbase];
    load_rows<T, K>(ec, e + base, stride);
    for (int m = 0; m < M; ++m) {
      const size_t i = base + (size_t)m * mstep;
      const size_t fi = fbase + (size_t)m * fstep;
      // the next marker's e (clamped at the last; re-read, unused)
      load_rows<T, K>(en, e + base + (size_t)min(m + 1, M - 1) * mstep,
                      stride);
      load_lam<T, K>(lr, lamq + (size_t)m * 64);
      if (Store) {
        store_rows<T, K>(fw_pre + i, p, stride);
        if (q == 0) fw_pre_f[fi] = f;
      }
      emit_norm<T, K>(p, f, ec, mask);
      if (Store) {
        store_rows<T, K>(fw_post + i, p, stride);
        if (q == 0) fw_post_f[fi] = f;
      }
      transition<T, K>(p, lr, q, mask);
#pragma unroll
      for (int j = 0; j < P; ++j) ec[j] = en[j];
    }
  } else {
    if (p_bwd != nullptr) {
      load_rows<T, K>(p, p_bwd + base, stride);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) p[j] = T(1);
    }
    if (f_bwd != nullptr) f = f_bwd[fbase];
    load_rows<T, K>(ec, e + base + (size_t)(M - 1) * mstep, stride);
    for (int m = M - 1; m >= 0; --m) {
      if (Store) {
        store_rows<T, K>(bw + base + (size_t)m * mstep, p, stride);
        if (q == 0) bw_f[fbase + (size_t)m * fstep] = f;
      }
      // a full sweep stops at marker 0; a carry steps on through the
      // interval below the block (both uniform over the chain)
      if (m > 0 || !Store) {
        if (m > 0)
          load_rows<T, K>(en, e + base + (size_t)(m - 1) * mstep, stride);
        load_lam<T, K>(lr, m > 0 ? lamq + (size_t)(m - 1) * 64
                                 : lam_below + q * P);
        emit_norm<T, K>(p, f, ec, mask);
        transition<T, K>(p, lr, q, mask);
        if (m > 0) {
#pragma unroll
          for (int j = 0; j < P; ++j) ec[j] = en[j];
        }
      }
    }
  }
  if (!Store) {
    store_rows<T, K>(p_out + base, p, stride);
    if (q == 0) f_out[fbase] = f;
  }
}

// x: unit tiles, y: shift, z: direction (both for a full sweep)
template <typename T>
dim3 sweep_grid(int R, int directions) {
  constexpr int units = kThreads / Lanes<T>::k;
  return dim3((R + units - 1) / units, 8, directions);
}

template <typename T>
int launch_fb(const T* e, const T* lam, T evengen, const T* p0, const T* f0,
              const T* bT, const T* bfT, T* fw_pre, T* fw_post, T* bw,
              T* fw_pre_f, T* fw_post_f, T* bw_f, int M, int R,
              void* stream) {
  if (M <= 0 || R <= 0) return 0;
  fb_sweep_kernel<T, Lanes<T>::k, true>
      <<<sweep_grid<T>(R, 2), kThreads, 0, (cudaStream_t)stream>>>(
          e, lam, nullptr, evengen, p0, f0, bT, bfT, fw_pre, fw_post, bw,
          fw_pre_f, fw_post_f, bw_f, nullptr, nullptr, M, R, 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_carry(const T* e, const T* lam, const T* lam_below, T evengen,
                 const T* p_in, const T* f_in, T* p_out, T* f_out,
                 int backward, int M, int R, void* stream) {
  if (M <= 0 || R <= 0 || (backward && lam_below == nullptr))
    return (int)cudaErrorInvalidValue;
  const int dir = backward ? 1 : 0;
  fb_sweep_kernel<T, Lanes<T>::k, false>
      <<<sweep_grid<T>(R, 1), kThreads, 0, (cudaStream_t)stream>>>(
          e, lam, lam_below, evengen, dir ? nullptr : p_in,
          dir ? nullptr : f_in, dir ? p_in : nullptr, dir ? f_in : nullptr,
          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, p_out, f_out,
          M, R, dir);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// p0/f0 seed the forward carry, bT/bfT the backward one at the last
// marker; null keeps evengen / ones and zero factors
int cnf_fb_sweep_f32(const float* e, const float* lam, float evengen,
                     const float* p0, const float* f0, const float* bT,
                     const float* bfT, float* fw_pre, float* fw_post,
                     float* bw, float* fw_pre_f, float* fw_post_f,
                     float* bw_f, int M, int R, void* stream) {
  return launch_fb<float>(e, lam, evengen, p0, f0, bT, bfT, fw_pre, fw_post,
                          bw, fw_pre_f, fw_post_f, bw_f, M, R, stream);
}

int cnf_fb_sweep_f64(const double* e, const double* lam, double evengen,
                     const double* p0, const double* f0, const double* bT,
                     const double* bfT, double* fw_pre, double* fw_post,
                     double* bw, double* fw_pre_f, double* fw_post_f,
                     double* bw_f, int M, int R, void* stream) {
  return launch_fb<double>(e, lam, evengen, p0, f0, bT, bfT, fw_pre,
                           fw_post, bw, fw_pre_f, fw_post_f, bw_f, M, R,
                           stream);
}

// carry-only: one direction, (p_in, f_in) in (null: the default seed),
// (p_out, f_out) out; lam_below [64] is the backward step's last row
int cnf_fb_carry_f32(const float* e, const float* lam,
                     const float* lam_below, float evengen,
                     const float* p_in, const float* f_in, float* p_out,
                     float* f_out, int backward, int M, int R,
                     void* stream) {
  return launch_carry<float>(e, lam, lam_below, evengen, p_in, f_in, p_out,
                             f_out, backward, M, R, stream);
}

int cnf_fb_carry_f64(const double* e, const double* lam,
                     const double* lam_below, double evengen,
                     const double* p_in, const double* f_in, double* p_out,
                     double* f_out, int backward, int M, int R,
                     void* stream) {
  return launch_carry<double>(e, lam, lam_below, evengen, p_in, f_in, p_out,
                              f_out, backward, M, R, stream);
}

}  // extern "C"
