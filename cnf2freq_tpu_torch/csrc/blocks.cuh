// Emission-block math shared by the emission and statistics kernels.
//
// Device-function form of the enum-leading helpers of
// cnf2freq_tpu/ops/stats_pallas.py (_match_raw_L, _phase_L, root_block_L)
// for the default F2 haplotyping model, zp == ZP_NONE, ci == False,
// update == 0, for one (marker, unit) pair.  Both kernels build the
// parent blocks (parent_block_L) from these as separable per-pair tables:
// an entry is a product of one factor per path bit.
//
// Slot order: 0=focal, 1=parent0, 2=gp00, 3=gp01, 4=parent1, 5=gp10,
// 6=gp11.  Parent-block entries are indexed (r0, fp, fpath, sk) with
// fp = gb1*4 + gb0*2 + p0 and fpath = rg1*4 + rg0*2 + rp.
//
// Built without --use_fast_math: exp/log and denormals must stay exact
// for the adjustprobs clip and the turn kernel's `tiny`.
#pragma once

#include <cuda_runtime.h>

namespace cnf {

constexpr int kUnknown = 0;    // MarkerVal 0 == unknown
constexpr int kSexMarker = 9;  // pseudo-allele of sex chromosomes
constexpr double kMinFactor = -1e15;

template <typename T>
struct Slot {
  int md[2];
  T ms[2];
  T hw;
  int exists;
  int attop;
};

template <typename T>
struct Root {
  T froot[2][2];  // [r0][s0]
  int vA[2];      // value into the continuing-branch parent, per r0
  T svA[2];
  int vB[2];      // value into the second-branch parent
  T svB[2];
};

template <typename T>
__device__ __forceinline__ T safe_div(T a, T b) {
  return b > T(0) ? a / b : T(0);
}

// markermiss + base-value arithmetic of one slot test (_match_raw_L)
template <typename T>
__device__ __forceinline__ void match_raw(int v, T sv, int mdj, T msj,
                                          T& bv, T& pre, int& bound) {
  const bool unknown_v = v == kUnknown;
  bound = unknown_v ? mdj : v;
  const bool miss = !unknown_v && !(mdj == kUnknown && v != kSexMarker) &&
                    v != mdj;
  const T effsecond = (unknown_v && bound != kUnknown) ? T(1) : sv;
  const T effms = mdj == kUnknown ? T(1) : msj;
  const T pre_match = effms * effsecond;
  const T pre_miss = (msj != T(0) && sv != T(0)) ? (T(1) - msj) * sv : T(0);
  bv = miss ? msj : T(1) - msj;
  pre = miss ? pre_miss : pre_match;
}

// phase-interpretation factor (_phase_L, haplotyping)
template <typename T>
__device__ __forceinline__ T phase(const Slot<T>& s, int f2n) {
  const bool collapse = s.md[0] == s.md[1] && s.ms[0] == s.ms[1];
  const T f = T(f2n);
  return collapse ? f : fabs(f - s.hw);
}

// (bv + pre) of one slot test: the matched value with the second channel
// absorbed (a grandparent's or attop parent's factor before its phase)
template <typename T>
__device__ __forceinline__ T matched(int v, T sv, int mdj, T msj) {
  T bv, pre;
  int bound;
  match_raw(v, sv, mdj, msj, bv, pre, bound);
  return bv + pre;
}

// focal term (root_block_L) with focal value `iv` (0 = unknown) and
// root side bit `side`
template <typename T>
__device__ __forceinline__ void root_block(const Slot<T>& f, int iv,
                                           int side, Root<T>& out) {
#pragma unroll
  for (int r0 = 0; r0 < 2; ++r0) {
    const T ms_r = f.ms[r0];
    const int md_o = f.md[1 - r0];
    const T ms_o = f.ms[1 - r0];
    T bv_raw, pre;
    int bound;
    match_raw(iv, T(0), f.md[r0], ms_r, bv_raw, pre, bound);
    const T bv_abs = bv_raw + pre;
    const T ms_nab = safe_div(pre, bv_raw);
    const bool collapse = f.md[0] == f.md[1] && f.ms[0] == f.ms[1];
    const T bv = f.attop ? bv_abs : bv_raw;
    const T secfac = ms_o != T(0) ? T(1) - ms_o : T(1);
#pragma unroll
    for (int s0 = 0; s0 < 2; ++s0) {
      const T f2n = T(r0 ^ side ^ s0);
      const T ph = collapse ? f2n : fabs(f2n - f.hw);
      out.froot[r0][s0] = f.attop ? bv_abs * ph : bv * ph * secfac;
    }
    out.vA[r0] = bound;
    out.svA[r0] = f.attop ? T(0) : ms_nab;
    out.vB[r0] = md_o;
    out.svB[r0] = ms_o != T(0) ? safe_div(ms_o, T(1) - ms_o) : T(0);
  }
}

// slot s of unit r at marker m from the [7,2,M,R] / [7,M,R] / [7,R]
// slot tensors
template <typename T>
__device__ __forceinline__ Slot<T> load_slot(const int* md, const T* ms,
                                             const T* hw, const int* ex,
                                             const int* at, int s, int m,
                                             int r, int M, int R) {
  Slot<T> out;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const size_t i = ((size_t)(s * 2 + a) * M + m) * R + r;
    out.md[a] = md[i];
    out.ms[a] = ms[i];
  }
  out.hw = hw[((size_t)s * M + m) * R + r];
  out.exists = ex[(size_t)s * R + r];
  out.attop = at[(size_t)s * R + r];
  return out;
}

}  // namespace cnf
