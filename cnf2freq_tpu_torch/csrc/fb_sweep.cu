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
// keeps the default).
//
// The carry-only entry (cnf_fb_carry_*: one direction, passes A and B of
// the blocked scan, the JAX package's lax.scans fb_carry_fwd /
// fb_carry_bwd, scan_v2.py:285-323) has a body of its own, below the
// sweeps': it stores no [M, 512, R] tensor and writes only the outgoing
// carry, the forward (p, f) after the last marker's transition (lam row
// M-1 crosses the block boundary) or the backward one after the step at
// marker 0 through lam_below, the interval below the block.  See its
// notes.
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
#include "pipeline.cuh"
#include "renorm.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

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

// both sweeps over the markers (blockIdx.z: 0 forward, 1 backward)
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    fb_sweep_kernel(const T* __restrict__ e, const T* __restrict__ lam,
                    T evengen, const T* __restrict__ p_fwd,
                    const T* __restrict__ f_fwd, const T* __restrict__ p_bwd,
                    const T* __restrict__ f_bwd, T* __restrict__ fw_pre,
                    T* __restrict__ fw_post, T* __restrict__ bw,
                    T* __restrict__ fw_pre_f, T* __restrict__ fw_post_f,
                    T* __restrict__ bw_f, int M, int R) {
  constexpr int P = 64 / K;
  const int q = threadIdx.x & (K - 1);
  const int r = blockIdx.x * (kThreads / K) + threadIdx.x / K;
  if (r >= R) return;  // the chain's K lanes share r, so all leave
  const unsigned mask = chain_mask<K>(threadIdx.x & 31);
  const size_t stride = R;
  const size_t mstep = (size_t)512 * stride;
  // element (m, n*64 + q*P + j, r) is base + m*mstep + j*stride; factor
  // (m, n, r) is fbase + m*fstep
  const size_t base = ((size_t)blockIdx.y * 64 + q * P) * stride + r;
  const size_t fbase = (size_t)blockIdx.y * stride + r;
  const size_t fstep = (size_t)8 * stride;
  const T* lamq = lam + q * P;
  T p[P], ec[P], en[P], lr[P];
  T f = T(0);

  if (blockIdx.z == 0) {
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
      store_rows<T, K>(fw_pre + i, p, stride);
      if (q == 0) fw_pre_f[fi] = f;
      emit_norm<T, K>(p, f, ec, mask);
      store_rows<T, K>(fw_post + i, p, stride);
      if (q == 0) fw_post_f[fi] = f;
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
      store_rows<T, K>(bw + base + (size_t)m * mstep, p, stride);
      if (q == 0) bw_f[fbase + (size_t)m * fstep] = f;
      // the sweep stops at marker 0 (uniform over the chain)
      if (m > 0) {
        load_rows<T, K>(en, e + base + (size_t)(m - 1) * mstep, stride);
        load_lam<T, K>(lr, lamq + (size_t)(m - 1) * 64);
        emit_norm<T, K>(p, f, ec, mask);
        transition<T, K>(p, lr, q, mask);
#pragma unroll
        for (int j = 0; j < P; ++j) ec[j] = en[j];
      }
    }
  }
}

// x: unit tiles, y: shift, z: direction
template <typename T>
dim3 sweep_grid(int R) {
  constexpr int units = kThreads / Lanes<T>::k;
  return dim3((R + units - 1) / units, 8, 2);
}

template <typename T>
int launch_fb(const T* e, const T* lam, T evengen, const T* p0, const T* f0,
              const T* bT, const T* bfT, T* fw_pre, T* fw_post, T* bw,
              T* fw_pre_f, T* fw_post_f, T* bw_f, int M, int R,
              void* stream) {
  if (M <= 0 || R <= 0) return 0;
  fb_sweep_kernel<T, Lanes<T>::k>
      <<<sweep_grid<T>(R), kThreads, 0, (cudaStream_t)stream>>>(
          e, lam, evengen, p0, f0, bT, bfT, fw_pre, fw_post, bw, fw_pre_f,
          fw_post_f, bw_f, M, R);
  return (int)cudaGetLastError();
}

// ---- the carry-only entry: its own body -------------------------------
//
// Bound on the H100: memory.  A launch reads e once (K x 512 x R values:
// 537 MB at K=256, R=1024 in float32, 0.160 ms at 3.35 TB/s) and stores
// only the outgoing carry.  With one direction a launch there are R x 8
// (unit, shift) chains, 8,192 at R=1024, each K dependent steps long, so
// the chain's step sets the time unless the step is short and enough
// bytes are in flight.  The sweep body above, whose stores and second
// direction hide its chain, took 0.46 ms here (35% of the bound): 16 IEEE
// quotients and a log on each step's chain, 64 shuffles a step in its two
// FWHTs, and e loaded one marker ahead.  This body:
//  - L = 4 lanes share a chain (kCarryL); lane q holds states i * L + q
//    (i < P = 64 / L), so the FWHT's strides 1 .. L / 2 are lane strides
//    (__shfl_xor_sync), L .. 32 register strides in the lane, in the plain
//    twin's ascending order; a warp covers UW = 32 / L units of one shift
//    (lane = q * UW + unit), so a warp's e rows at one marker are 64 runs of
//    UW contiguous values;
//  - the scaled carry (y, c) of csrc/renorm.cuh: no division and no log on
//    the chain (the power of two that keeps c in [1, 2) is folded into the
//    eigenvalue row), one log and one division of the outgoing p at the
//    end (divide_all: y / c bit for bit);
//  - each warp stages its own e rows and the step's lam row into a ring of
//    marker slots in shared memory (cp.async, csrc/pipeline.cuh), one
//    slot fewer markers ahead, so no block-wide barrier; a slot's e rows
//    are [64][UW] values, which the warp's lanes read without bank
//    conflicts.
// Its results differ from the plain twin's by rounding order only (the
// twin divides by s at every step); dead rows (s = 0) give zeros and
// MINFACTOR, as the twin does.
// Kept from variant runs in turns at that block (kernel_ab.py, CUDA-graph
// replays, NVIDIA H100 80GB HBM3, 700.00 W): L = 4 in both types, the
// fewest shuffles that keep a lane's carry in registers (bare, float /
// double: L = 8 0.325 / 0.462 ms, L = 16 0.567 / 0.665, L = 2 0.279 in
// float); a ring of 3 markers in float (4: 0.244, 2: 0.260) and 2 in
// double (4: 0.446, 3: 0.406).  Measured: 0.228-0.230 / 0.372-0.393 ms a
// launch, 71% / 82-87% of the bound (the body above: 0.459 / 0.697);
// -Xptxas -v: 64 / 93 registers, no spills.  e is staged by 16-byte
// copies, so the launcher refuses a row of R values that is not a whole
// number of them, or an e that is not 16-byte aligned (ops/scan.py pads R
// to 32 units).

constexpr int kCarryWarps = 4;  // warps a block
constexpr int kCarryL = 4;      // lanes a chain

// ring slots (one marker each), kept per type
template <typename T>
struct CarryStages;
template <>
struct CarryStages<float> {
  static constexpr int n = 3;
};
template <>
struct CarryStages<double> {
  static constexpr int n = 2;
};

template <typename T>
struct CarryShape {
  static constexpr int L = kCarryL;
  static constexpr int P = 64 / L;     // states a lane
  static constexpr int UW = 32 / L;    // units a warp
  static constexpr int E = 64 * UW;    // e values of a warp's marker
  static constexpr int SLOT = E + 64;  // a ring slot: e rows, the lam row
  static constexpr int W = 16 / (int)sizeof(T);  // values a 16-byte copy
  static_assert(UW % W == 0, "a warp's run of a row: whole 16-byte copies");
  static constexpr int NT = CarryStages<T>::n;
  static_assert(NT >= 2, "the ring needs two slots");
  static constexpr size_t smem =
      (size_t)kCarryWarps * NT * SLOT * sizeof(T);  static_assert(smem <= 48 * 1024, "the ring: default shared memory");
};

// Issue the copies of one marker into a ring slot as one commit group
// (an empty group past the last step, so the counts stay uniform): the
// warp's e rows from `at` (state 0 of its first unit; row stride R,
// `left` units from there inside R) and the lam row, by 16-byte copies.
template <typename T>
__device__ __forceinline__ void stage_marker(T* slot,
                                             const T* __restrict__ at,
                                             size_t R, int left,
                                             const T* __restrict__ lrow,
                                             int lane) {
  using S = CarryShape<T>;
  constexpr int W = S::W, per_row = S::UW / W;
  if (at != nullptr) {
#pragma unroll
    for (int c = lane; c < 64 * per_row; c += 32) {
      const int row = c / per_row, u = (c % per_row) * W;
      // W | R, so a copy lies wholly inside R or not
      if (u < left)
        cnf::copy_async<16>(slot + row * S::UW + u, at + row * R + u);
    }
    if (lane < 64 / W)
      cnf::copy_async<16>(slot + S::E + lane * W, lrow + lane * W);
  }
  cnf::commit_group();
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// the unnormalised FWHT64 of a chain's row, lane q holding states
// i * L + q: strides 1 .. L / 2 across the lanes (lane bit of q, the
// shuffle offset h * UW), then L .. 32 between the lane's registers
template <typename T>
__device__ __forceinline__ void carry_fwht(T (&x)[CarryShape<T>::P],
                                           int q) {
  constexpr int L = kCarryL, P = 64 / L, UW = 32 / L;
#pragma unroll
  for (int h = 1; h < L; h <<= 1) {
    // upper lane: o - x, lower lane: x + o, each rounded once
    const T sign = (q & h) ? T(-1) : T(1);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const T o = __shfl_xor_sync(kFullMask, x[i], h * UW);
      x[i] = fma_rn(sign, x[i], o);
    }
  }
#pragma unroll
  for (int h = 1; h < P; h <<= 1)
#pragma unroll
    for (int i = 0; i < P; ++i)
      if ((i & h) == 0) {
        const T a = x[i], b = x[i + h];
        x[i] = a + b;
        x[i + h] = a - b;
      }
}

// one direction over K markers: per (unit, shift) chain, from the carry
// (p_in, f_in) (null: evengen / ones, 0) to (p_out, f_out)
template <typename T>
__global__ void __launch_bounds__(kCarryWarps * 32)
    fb_carry_kernel(const T* __restrict__ e, const T* __restrict__ lam,
                    const T* __restrict__ lam_below, T evengen,
                    const T* __restrict__ p_in, const T* __restrict__ f_in,
                    T* __restrict__ p_out, T* __restrict__ f_out,
                    int backward, int K, int R) {
  using S = CarryShape<T>;
  constexpr int L = S::L, P = S::P, UW = S::UW, NT = S::NT;
  extern __shared__ __align__(16) unsigned char carry_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kCarryWarps + warp) * UW;
  if (r0 >= R) return;  // the whole warp: no barrier below spans warps
  T* ring = reinterpret_cast<T*>(carry_smem) + (size_t)warp * NT * S::SLOT;
  const int q = lane / UW, uw = lane % UW;
  const int r = r0 + uw;
  const bool active = r < R;
  const size_t stride = R;
  const size_t mstep = (size_t)512 * stride;
  const size_t n64 = (size_t)blockIdx.y * 64;
  // the warp's state 0 at marker 0
  const T* ew = e + n64 * stride + r0;

  // step j takes marker m = j forward, K - 1 - j backward, and the
  // interval leaving m forward, entering it backward (lam_below at 0)
  auto stage = [&](int j) {
    const T* at = nullptr;
    const T* lrow = nullptr;
    if (j < K) {
      const int m = backward ? K - 1 - j : j;
      at = ew + (size_t)m * mstep;
      lrow = !backward ? lam + (size_t)m * 64
             : m > 0   ? lam + (size_t)(m - 1) * 64
                       : lam_below;
    }
    stage_marker<T>(ring + (j % NT) * S::SLOT, at, stride, R - r0, lrow,
                    lane);
  };
#pragma unroll
  for (int j = 0; j < NT - 1; ++j) stage(j);

  // the chain's scaled carry (x, c) and its log-factor (csrc/renorm.cuh)
  T x[P];
  T f0 = T(0);
  if (active) {
    if (p_in != nullptr) {
#pragma unroll
      for (int i = 0; i < P; ++i)
        x[i] = p_in[(n64 + i * L + q) * stride + r];
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) x[i] = backward ? T(1) : evengen;
    }
    if (f_in != nullptr) f0 = f_in[blockIdx.y * stride + r];
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) x[i] = T(0);
  }
  T c = T(1);
  cnf::LogFactor<T> lf{f0};
  for (int j = 0; j < K; ++j) {
    cnf::wait_groups<NT - 2>();
    __syncwarp();
    // into the slot that step j - 1 read, which every lane has passed
    stage(j + NT - 1);
    const T* slot = ring + (j % NT) * S::SLOT;
    const T thr = Clip<T>::v * c;
    T s = T(0), lr[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int st = i * L + q;
      x[i] = (x[i] < thr ? T(0) : x[i]) * slot[st * UW + uw];
      s += x[i];
      lr[i] = slot[S::E + st];
    }
#pragma unroll
    for (int o = 1; o < L; o <<= 1) s += __shfl_xor_sync(kFullMask, s, o * UW);
    const int ex = cnf::Pow2<T>::exponent(s);
    // the 1/64 and the power of two that brings c into [1, 2), exact
    const T scale = cnf::Pow2<T>::pow2(ex, 6);
    carry_fwht<T>(x, q);
#pragma unroll
    for (int i = 0; i < P; ++i) x[i] *= lr[i] * scale;
    carry_fwht<T>(x, q);
    c = s * cnf::Pow2<T>::pow2(ex, 0);
    lf.count(s, ex);
  }
  cnf::wait_groups<0>();
  if (active) {
    cnf::unscale(x, c);
#pragma unroll
    for (int i = 0; i < P; ++i) p_out[(n64 + i * L + q) * stride + r] = x[i];
    if (q == 0) f_out[blockIdx.y * stride + r] = lf.value();
  }
}

template <typename T>
int launch_carry(const T* e, const T* lam, const T* lam_below, T evengen,
                 const T* p_in, const T* f_in, T* p_out, T* f_out,
                 int backward, int K, int R, void* stream) {
  if (K <= 0 || R <= 0 || (backward && lam_below == nullptr))
    return (int)cudaErrorInvalidValue;
  // e and the lam rows are staged by 16-byte copies
  if (((size_t)R * sizeof(T)) % 16 != 0 || ((size_t)e & 15) != 0 ||
      ((size_t)lam & 15) != 0 ||
      (backward && ((size_t)lam_below & 15) != 0))
    return (int)cudaErrorMisalignedAddress;
  using S = CarryShape<T>;
  constexpr int units = kCarryWarps * S::UW;
  fb_carry_kernel<T><<<dim3((R + units - 1) / units, 8), kCarryWarps * 32,
                       S::smem, (cudaStream_t)stream>>>(
      e, lam, lam_below, evengen, p_in, f_in, p_out, f_out,
      backward ? 1 : 0, K, R);
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
