// Forward and backward sweeps of the extended state spaces (SELFING,
// RELSKEWSTATES) in the [B, M, V, NS, 64] layout (state minor), V in
// {2, 3}.
//
// Replaces the two XLA lax.scans of
// cnf2freq_tpu/engine_ext.py::extended_forward_backward (forward at
// :191, backward at :210), which the JAX package runs for
// ModelConfig(selfing=True) (V = 3 HBD statuses) and
// ModelConfig(relskewstates=True) (V = 2 coherence-bit values).  It is a
// kernel for an XLA program of the JAX package, not for a Pallas kernel.
// Per (unit b, shift ns) the V x 64 carry steps through the markers as
// the XLA scans do:
//   zero values below `clip` (the scan's 1e-300, passed in the kernel's
//   type: in float32 it is 0, so nothing is clipped, as in JAX), multiply
//   by e, renormalise over the (V, state) axes jointly with log-factor
//   accumulation (MINFACTOR when the sum is 0), apply the xor transition
//   H . diag(lam) . H / 64 to each of the V rows, then mix the rows with
//   the unit's [V, V] coupling of the interval: out[g] = sum_f C[f][g]
//   in[f] (row = from, column = to).
// The forward carry starts at the prior row prior[b, v] in every state
// (EVENGEN, times the selfing HBD split) and stores fw_pre (before the
// emission) and fw_post (after it), using lam row m and C[b, m] (the
// wrapper pads lam with ones and C with the identity at m = M - 1); the
// backward carry starts at ones, stores bw at each marker m and steps to
// m - 1 with lam row m - 1 and C[b, m - 1] in the SAME from -> to
// orientation as the forward sweep (not its transpose), as the JAX scan
// and the reference do; this only shows for the non-symmetric selfing
// coupling.
//
// The marker-blocked scan of the extended spaces (blocked_families.py)
// runs two more entries, kernels for the lax.scans of the JAX package's
// cnf2freq_tpu/blocked_families.py (carry_f at :143, carry_b at :160,
// block_pass's two at :210 and :224), which replace no Pallas kernel
// either:
//   cnf_fb_ext_init_*   both sweeps over one block from boundary carries:
//                       the forward from p0 [B, V, NS, 64], f0 [B, NS]
//                       entering the block (instead of the prior), the
//                       backward from bT, bfT, bw at the block's last
//                       marker; lam row and C column j are the interval
//                       leaving marker j of the block;
//   cnf_fb_ext_carry_*  one direction carry-only (one warp a row, as
//                       above): forward from the carry entering the
//                       block to the one entering the next; backward
//                       from bw at the block's last marker through
//                       markers K-1..0, the step at marker 0 taking
//                       lam_below and C_below [B, V, V], the interval
//                       below the block, in the same from -> to
//                       orientation.  It reads e and C once and stores
//                       only the outgoing carry.
//
// Bound on the H100: memory.  Per marker a warp reads V rows of e and
// writes two stored rows forward (fw_pre, fw_post) or one backward (bw):
// at B = 1000, M = 192, V = 3 that is 4.7 GB in float32.  One warp owns a
// (unit, shift): lane l holds states l and l + 32 of each of the V rows
// (2V registers), the joint renormalising sum is one warp reduction of
// the lane's 2V values, the 64-point FWHT of each row runs as in
// csrc/fb_classic.cu (the stride-32 stage inside the thread, strides
// 16..1 by __shfl_xor_sync), and the [V, V] mix is per lane.  Forward and
// backward sweeps are independent and run as the two halves of one grid
// (gridDim.y == 2).  The next marker's e rows are loaded before the
// current step's arithmetic.  No fast math: the clip and log must stay
// exact.
#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// unnormalised 64-point Walsh-Hadamard transform of one row held by the
// warp (lane l: states l and l + 32)
template <typename T>
__device__ __forceinline__ void fwht64(T& lo, T& hi, int lane) {
  const T a = lo + hi, b = lo - hi;
  lo = a;
  hi = b;
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    const T olo = __shfl_xor_sync(kFull, lo, h);
    const T ohi = __shfl_xor_sync(kFull, hi, h);
    const bool upper = (lane & h) != 0;
    lo = upper ? olo - lo : lo + olo;
    hi = upper ? ohi - hi : hi + ohi;
  }
}

// clip, emit, renormalise over the V rows jointly (adjustprobs over the
// extended state)
template <typename T, int V>
__device__ __forceinline__ void emit_norm(T (&lo)[V], T (&hi)[V], T& f,
                                          const T (&elo)[V],
                                          const T (&ehi)[V], T clip) {
  T part = T(0);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    lo[v] = (lo[v] < clip ? T(0) : lo[v]) * elo[v];
    hi[v] = (hi[v] < clip ? T(0) : hi[v]) * ehi[v];
    part += lo[v] + hi[v];
  }
  const T s = warp_sum(part);  // the same value in every lane
  if (s > T(0)) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      lo[v] = lo[v] / s;
      hi[v] = hi[v] / s;
    }
    f = f + log(s);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      lo[v] = T(0);
      hi[v] = T(0);
    }
    f = T(cnf::kMinFactor);
  }
}

// the base-state transition of every row, then the [V, V] coupling mix
template <typename T, int V>
__device__ __forceinline__ void transition(T (&lo)[V], T (&hi)[V],
                                           const T* lam, const T* c,
                                           int lane) {
  const T llo = lam[lane], lhi = lam[lane + 32];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    fwht64(lo[v], hi[v], lane);
    lo[v] *= llo;
    hi[v] *= lhi;
    fwht64(lo[v], hi[v], lane);
    lo[v] *= T(1.0 / 64.0);
    hi[v] *= T(1.0 / 64.0);
  }
  T cm[V * V];
#pragma unroll
  for (int k = 0; k < V * V; ++k) cm[k] = c[k];
  T nlo[V], nhi[V];
#pragma unroll
  for (int g = 0; g < V; ++g) {
    nlo[g] = T(0);
    nhi[g] = T(0);
#pragma unroll
    for (int fr = 0; fr < V; ++fr) {
      nlo[g] += cm[fr * V + g] * lo[fr];
      nhi[g] += cm[fr * V + g] * hi[fr];
    }
  }
#pragma unroll
  for (int g = 0; g < V; ++g) {
    lo[g] = nlo[g];
    hi[g] = nhi[g];
  }
}

// the carry of one (unit, shift) row in the warp's registers: from
// (p [B, V, NS, 64], pf [B, NS]) where given, else every state of row v
// at seed[b * V + v] (the prior) or at 1 (seed null), f 0
template <typename T, int V>
__device__ __forceinline__ void seed_row(T (&lo)[V], T (&hi)[V], T& f,
                                         const T* p, const T* pf,
                                         const T* seed, int b, int ns,
                                         int NS, int lane) {
  if (p != nullptr) {
    const size_t vstep = (size_t)NS * 64;
    const size_t base = (size_t)b * V * vstep + (size_t)ns * 64 + lane;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      lo[v] = p[base + v * vstep];
      hi[v] = p[base + v * vstep + 32];
    }
    f = pf[(size_t)b * NS + ns];
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      lo[v] = hi[v] = seed != nullptr ? seed[(size_t)b * V + v] : T(1);
    f = T(0);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
    fb_ext_kernel(const T* __restrict__ e, const T* __restrict__ lam,
                  const T* __restrict__ C, const T* __restrict__ prior,
                  const T* __restrict__ p0, const T* __restrict__ f0,
                  const T* __restrict__ bT, const T* __restrict__ bfT,
                  T* __restrict__ fw_pre, T* __restrict__ fw_post,
                  T* __restrict__ bw, T* __restrict__ fw_pre_f,
                  T* __restrict__ fw_post_f, T* __restrict__ bw_f, int B,
                  int M, int NS, T clip) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)B * NS) return;
  const int b = (int)(row / NS), ns = (int)(row % NS);
  // element (b, m, v, ns, s) is base + m * mstep + v * vstep + s; factor
  // (b, m, ns) is fbase + m * NS; coupling (b, m) starts at C + cbase +
  // m * V * V
  const size_t vstep = (size_t)NS * 64;
  const size_t mstep = (size_t)V * vstep;
  const size_t base = (size_t)b * M * mstep + (size_t)ns * 64 + lane;
  const size_t fbase = (size_t)b * M * NS + ns;
  const size_t cbase = (size_t)b * M * V * V;

  T lo[V], hi[V], elo[V], ehi[V], nlo[V], nhi[V];
  if (blockIdx.y == 0) {
    T f;
    seed_row<T, V>(lo, hi, f, p0, f0, prior, b, ns, NS, lane);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      elo[v] = e[base + v * vstep];
      ehi[v] = e[base + v * vstep + 32];
      nlo[v] = nhi[v] = T(0);
    }
    for (int m = 0; m < M; ++m) {
      const size_t i = base + (size_t)m * mstep;
      if (m + 1 < M) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          nlo[v] = e[i + mstep + v * vstep];
          nhi[v] = e[i + mstep + v * vstep + 32];
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        fw_pre[i + v * vstep] = lo[v];
        fw_pre[i + v * vstep + 32] = hi[v];
      }
      if (lane == 0) fw_pre_f[fbase + (size_t)m * NS] = f;
      emit_norm<T, V>(lo, hi, f, elo, ehi, clip);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        fw_post[i + v * vstep] = lo[v];
        fw_post[i + v * vstep + 32] = hi[v];
      }
      if (lane == 0) fw_post_f[fbase + (size_t)m * NS] = f;
      transition<T, V>(lo, hi, lam + (size_t)m * 64,
                       C + cbase + (size_t)m * V * V, lane);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        elo[v] = nlo[v];
        ehi[v] = nhi[v];
      }
    }
  } else {
    T f;
    seed_row<T, V>(lo, hi, f, bT, bfT, nullptr, b, ns, NS, lane);
    const size_t last = base + (size_t)(M - 1) * mstep;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      elo[v] = e[last + v * vstep];
      ehi[v] = e[last + v * vstep + 32];
    }
    for (int m = M - 1; m >= 0; --m) {
      const size_t i = base + (size_t)m * mstep;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        bw[i + v * vstep] = lo[v];
        bw[i + v * vstep + 32] = hi[v];
      }
      if (lane == 0) bw_f[fbase + (size_t)m * NS] = f;
      if (m > 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          nlo[v] = e[i - mstep + v * vstep];
          nhi[v] = e[i - mstep + v * vstep + 32];
        }
        emit_norm<T, V>(lo, hi, f, elo, ehi, clip);
        transition<T, V>(lo, hi, lam + (size_t)(m - 1) * 64,
                         C + cbase + (size_t)(m - 1) * V * V, lane);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          elo[v] = nlo[v];
          ehi[v] = nhi[v];
        }
      }
    }
  }
}

// one direction, carry-only: per (unit, shift) row, one warp takes the
// carry (p_in, f_in) through the block's K markers into (p_out, f_out)
template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
    fb_ext_carry_kernel(const T* __restrict__ e, const T* __restrict__ lam,
                        const T* __restrict__ C,
                        const T* __restrict__ lam_below,
                        const T* __restrict__ C_below,
                        const T* __restrict__ p_in,
                        const T* __restrict__ f_in, T* __restrict__ p_out,
                        T* __restrict__ f_out, int backward, int B, int K,
                        int NS, T clip) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)B * NS) return;
  const int b = (int)(row / NS), ns = (int)(row % NS);
  const size_t vstep = (size_t)NS * 64;
  const size_t mstep = (size_t)V * vstep;
  const size_t base = (size_t)b * K * mstep + (size_t)ns * 64 + lane;
  const size_t cbase = (size_t)b * K * V * V;
  T lo[V], hi[V], elo[V], ehi[V], nlo[V], nhi[V];
  T f;
  seed_row<T, V>(lo, hi, f, p_in, f_in, nullptr, b, ns, NS, lane);
  const int first = backward ? K - 1 : 0;
  const int dir = backward ? -1 : 1;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    elo[v] = e[base + (size_t)first * mstep + v * vstep];
    ehi[v] = e[base + (size_t)first * mstep + v * vstep + 32];
    nlo[v] = nhi[v] = T(0);
  }
  for (int j = 0; j < K; ++j) {
    const int m = first + dir * j;
    if (j + 1 < K) {
      const size_t i = base + (size_t)(m + dir) * mstep;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        nlo[v] = e[i + v * vstep];
        nhi[v] = e[i + v * vstep + 32];
      }
    }
    emit_norm<T, V>(lo, hi, f, elo, ehi, clip);
    // forward: the interval leaving m; backward: the one entering m
    const T* lam_m;
    const T* c_m;
    if (!backward) {
      lam_m = lam + (size_t)m * 64;
      c_m = C + cbase + (size_t)m * V * V;
    } else if (m > 0) {
      lam_m = lam + (size_t)(m - 1) * 64;
      c_m = C + cbase + (size_t)(m - 1) * V * V;
    } else {
      lam_m = lam_below;
      c_m = C_below + (size_t)b * V * V;
    }
    transition<T, V>(lo, hi, lam_m, c_m, lane);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      elo[v] = nlo[v];
      ehi[v] = nhi[v];
    }
  }
  const size_t out = (size_t)b * V * vstep + (size_t)ns * 64 + lane;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p_out[out + v * vstep] = lo[v];
    p_out[out + v * vstep + 32] = hi[v];
  }
  if (lane == 0) f_out[row] = f;
}

template <typename T>
int launch_fb_ext(const T* e, const T* lam, const T* C, const T* prior,
                  const T* p0, const T* f0, const T* bT, const T* bfT,
                  T* fw_pre, T* fw_post, T* bw, T* fw_pre_f, T* fw_post_f,
                  T* bw_f, int B, int M, int V, int NS, T clip,
                  void* stream) {
  if (B <= 0 || M <= 0 || NS <= 0) return 0;
  const long long rows = (long long)B * NS;
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps), 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (V == 2) {
    fb_ext_kernel<T, 2><<<grid, kWarps * 32, 0, s>>>(
        e, lam, C, prior, p0, f0, bT, bfT, fw_pre, fw_post, bw, fw_pre_f,
        fw_post_f, bw_f, B, M, NS, clip);
  } else if (V == 3) {
    fb_ext_kernel<T, 3><<<grid, kWarps * 32, 0, s>>>(
        e, lam, C, prior, p0, f0, bT, bfT, fw_pre, fw_post, bw, fw_pre_f,
        fw_post_f, bw_f, B, M, NS, clip);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fb_ext_carry(const T* e, const T* lam, const T* C,
                        const T* lam_below, const T* C_below, const T* p_in,
                        const T* f_in, T* p_out, T* f_out, int backward,
                        int B, int K, int V, int NS, T clip, void* stream) {
  if (p_in == nullptr || f_in == nullptr) return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0 || NS <= 0) return 0;
  const long long rows = (long long)B * NS;
  const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  if (V == 2) {
    fb_ext_carry_kernel<T, 2><<<grid, kWarps * 32, 0, s>>>(
        e, lam, C, lam_below, C_below, p_in, f_in, p_out, f_out, backward, B,
        K, NS, clip);
  } else if (V == 3) {
    fb_ext_carry_kernel<T, 3><<<grid, kWarps * 32, 0, s>>>(
        e, lam, C, lam_below, C_below, p_in, f_in, p_out, f_out, backward, B,
        K, NS, clip);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cnf_fb_ext_f32(const float* e, const float* lam, const float* C,
                   const float* prior, float* fw_pre, float* fw_post,
                   float* bw, float* fw_pre_f, float* fw_post_f, float* bw_f,
                   int B, int M, int V, int NS, float clip, void* stream) {
  if (prior == nullptr) return (int)cudaErrorInvalidValue;
  return launch_fb_ext<float>(e, lam, C, prior, nullptr, nullptr, nullptr,
                              nullptr, fw_pre, fw_post, bw, fw_pre_f,
                              fw_post_f, bw_f, B, M, V, NS, clip, stream);
}

int cnf_fb_ext_f64(const double* e, const double* lam, const double* C,
                   const double* prior, double* fw_pre, double* fw_post,
                   double* bw, double* fw_pre_f, double* fw_post_f,
                   double* bw_f, int B, int M, int V, int NS, double clip,
                   void* stream) {
  if (prior == nullptr) return (int)cudaErrorInvalidValue;
  return launch_fb_ext<double>(e, lam, C, prior, nullptr, nullptr, nullptr,
                               nullptr, fw_pre, fw_post, bw, fw_pre_f,
                               fw_post_f, bw_f, B, M, V, NS, clip, stream);
}

int cnf_fb_ext_init_f32(const float* e, const float* lam, const float* C,
                        const float* p0, const float* f0, const float* bT,
                        const float* bfT, float* fw_pre, float* fw_post,
                        float* bw, float* fw_pre_f, float* fw_post_f,
                        float* bw_f, int B, int K, int V, int NS, float clip,
                        void* stream) {
  if (p0 == nullptr || f0 == nullptr) return (int)cudaErrorInvalidValue;
  return launch_fb_ext<float>(e, lam, C, nullptr, p0, f0, bT, bfT, fw_pre,
                              fw_post, bw, fw_pre_f, fw_post_f, bw_f, B, K, V,
                              NS, clip, stream);
}

int cnf_fb_ext_init_f64(const double* e, const double* lam, const double* C,
                        const double* p0, const double* f0, const double* bT,
                        const double* bfT, double* fw_pre, double* fw_post,
                        double* bw, double* fw_pre_f, double* fw_post_f,
                        double* bw_f, int B, int K, int V, int NS,
                        double clip, void* stream) {
  if (p0 == nullptr || f0 == nullptr) return (int)cudaErrorInvalidValue;
  return launch_fb_ext<double>(e, lam, C, nullptr, p0, f0, bT, bfT, fw_pre,
                               fw_post, bw, fw_pre_f, fw_post_f, bw_f, B, K,
                               V, NS, clip, stream);
}

int cnf_fb_ext_carry_f32(const float* e, const float* lam, const float* C,
                         const float* lam_below, const float* C_below,
                         const float* p_in, const float* f_in, float* p_out,
                         float* f_out, int backward, int B, int K, int V,
                         int NS, float clip, void* stream) {
  return launch_fb_ext_carry<float>(e, lam, C, lam_below, C_below, p_in, f_in,
                                    p_out, f_out, backward, B, K, V, NS, clip,
                                    stream);
}

int cnf_fb_ext_carry_f64(const double* e, const double* lam, const double* C,
                         const double* lam_below, const double* C_below,
                         const double* p_in, const double* f_in,
                         double* p_out, double* f_out, int backward, int B,
                         int K, int V, int NS, double clip, void* stream) {
  return launch_fb_ext_carry<double>(e, lam, C, lam_below, C_below, p_in,
                                     f_in, p_out, f_out, backward, B, K, V,
                                     NS, clip, stream);
}

}  // extern "C"
