// Emission kernel: e[m, x, r] for the default F2 haplotyping model.
//
// Replaces the TPU kernel cnf2freq_tpu/ops/scan_v2.py::_e_kernel (body
// _e_tile, launcher emission_tiles).  Per (marker m, unit r) the emission
// over the 512 features x = ((s2*2 + s1)*2 + s0)*64 + fp1*8 + fp0 is
// rebuilt from ~50 slot scalars: the focal (root) term times the two
// parent blocks summed over paths,
//     e[v,u,t,b,a] = sum_r froot[r,t] * pbs0[r,a,u] * pbs1[r,b,v],
// or the root term alone when the focal is a recursion top.
//
// What the TPU body does: it enumerates every parent-block entry
// (r0, fp, fpath, sk) as one vector lane and evaluates the full
// parent_block_L expression in each (one parent match, two grandparent
// matches, three phase factors), 2 x 256 entries a pair, then writes the
// 512 outputs.  Done one thread per pair on a GPU, that is ~1,500 match
// evaluations a pair, and the 512 stores come only after all of them.
//
// Bound on the H100: bytes, the M*512*R outputs (403 MB at M=192,
// R=1024 in f32, 0.128 ms at 3.35 TB/s; 0.254 ms in f64) against ~28 MB
// of slot loads.  Design:
//   1. Separable parent blocks.  The sum over fpath = (rg1, rg0, rp)
//      factors, because the canonical-path weight is one condition per
//      path bit: per side k and root branch r0,
//        pbs[fp, sk] = sum_rp A[rp] * PH[rp ^ p0 ^ sk] * G(rp, fp),
//        G = F[rp][0][gb0] * S[rp][1][gb1]   (p0 = 0)
//          = F[rp][1][gb1] * S[rp][0][gb0]   (p0 = 1),
//      where A carries the parent's match and sec_f, F[rp][j][gb] the
//      grandparent j's match of the branch's bound value summed over rg
//      with its phase factors, S the same for the parent's other allele,
//      PH the parent's phase.  A vacant parent (A = 1 + sv at rp = 0)
//      and an attop parent (A = bv_raw + pre, no grandparent factor) pick
//      the factors by select.  ~20 match evaluations a thread, four
//      threads a pair (one per (k, r0)), instead of ~1,500 a pair.
//   2. The block's U units write froot [2][2] and pbs [2][2][8][2] (68
//      values a unit) to shared memory, the unit index fastest; a focal
//      top writes its tops values in place of froot and ones in place of
//      pbs, so that it goes through the same store loop.
//   3. All of the block's threads then stream the 512 x U outputs: a
//      thread takes V consecutive units and 4 / V combinations (a, t),
//      keeps froot * pbs0 for both u in registers and, per (v, b), reads
//      the two pbs1 values once for two stores.  Stores are streaming
//      (__stcs: e is 8x the L2) and cover whole sectors.  Several blocks
//      share an SM, so one block's tables overlap another's stores.
// U and V per type (Tile below) were chosen from a variant run over
// U = 64, 128 and V = 1, 4 (f32) or 1, 2 (f64) on the H100: all within
// 4% in f32, U = 64, V = 4 (16-byte stores) fastest at 82% of the bound;
// in f64 V = 2 took 254 registers a thread (one block an SM) and lost to
// V = 1 by 4%.
#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kUnits = 64; static constexpr int kVec = 4;
};
template <>
struct Tile<double> {
  static constexpr int kUnits = 64; static constexpr int kVec = 1;
};

// shared-memory rows of a unit's values: froot [r0][t], then the two
// path-summed parent blocks [r0][f][s] of side 0 and side 1
constexpr int kFroot = 0, kPb0 = 4, kPb1 = 36, kRows = 68;

// V consecutive values from shared memory, and to device memory with
// streaming stores: V scalar accesses, or one 16-byte access for 4 floats
template <typename T, int V>
__device__ __forceinline__ void ld(const T* p, T (&o)[V]) {
#pragma unroll
  for (int w = 0; w < V; ++w) o[w] = p[w];
}
__device__ __forceinline__ void ld(const float* p, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x;
  o[1] = q.y;
  o[2] = q.z;
  o[3] = q.w;
}
template <typename T, int V>
__device__ __forceinline__ void st(T* p, const T (&v)[V]) {
#pragma unroll
  for (int w = 0; w < V; ++w) __stcs(p + w, v[w]);
}
__device__ __forceinline__ void st(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// Phase 1 for unit r, side k, root branch r0: the 16 path-summed entries
// pbs[k][r0][fp][sk] into rows kPb0/kPb1, and froot[r0][.] (side 0's
// threads) into rows kFroot, at column i.
template <typename T, int U>
__device__ __forceinline__ void unit_tables(
    const int* __restrict__ md, const T* __restrict__ ms,
    const T* __restrict__ hw, const int* __restrict__ ex,
    const int* __restrict__ at, T (*s)[U], int i, int k, int r0, int m,
    int r, int M, int R) {
  const cnf::Slot<T> f = cnf::load_slot(md, ms, hw, ex, at, 0, m, r, M, R);
  cnf::Root<T> root;
  cnf::root_block(f, 0, 0, root);
  const cnf::Slot<T> par = cnf::load_slot(md, ms, hw, ex, at, 1 + 3 * k, m,
                                          r, M, R);
  const cnf::Slot<T> gp0 = cnf::load_slot(md, ms, hw, ex, at, 2 + 3 * k, m,
                                          r, M, R);
  const cnf::Slot<T> gp1 = cnf::load_slot(md, ms, hw, ex, at, 3 + 3 * k, m,
                                          r, M, R);
  // the branch value into this side's parent (selects, not indexing, so
  // that nothing goes to local memory)
  const int v = k == 0 ? (r0 ? root.vA[1] : root.vA[0])
                       : (r0 ? root.vB[1] : root.vB[0]);
  const T sv = k == 0 ? (r0 ? root.svA[1] : root.svA[0])
                      : (r0 ? root.svB[1] : root.svB[0]);
  const bool deep_ok = par.exists && !par.attop;

  T A[2], F[2][2][2], S[2][2][2];  // [rp], [rp][j][gb]
#pragma unroll
  for (int rp = 0; rp < 2; ++rp) {
    T bv_raw, pre;
    int bound;
    cnf::match_raw(v, sv, par.md[rp], par.ms[rp], bv_raw, pre, bound);
    const T ms_nab = cnf::safe_div(pre, bv_raw);
    const int md_o = par.md[1 - rp];
    const T ms_o = par.ms[1 - rp];
    const T sec_f = ms_o != T(0) ? T(1) - ms_o : T(1);
    const T secsec = ms_o != T(0) ? cnf::safe_div(ms_o, T(1) - ms_o) : T(0);
    A[rp] = !par.exists ? (rp == 0 ? T(1) + sv : T(0))
            : par.attop ? bv_raw + pre
                        : bv_raw * sec_f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const cnf::Slot<T>& gp = j == 0 ? gp0 : gp1;
      const bool both = deep_ok && gp.exists;  // rg = 1 allowed
      T gf[2], gs[2];
#pragma unroll
      for (int rg = 0; rg < 2; ++rg) {
        gf[rg] = gp.exists ? cnf::matched(bound, ms_nab, gp.md[rg], gp.ms[rg])
                           : T(1) + ms_nab;
        gs[rg] = gp.exists ? cnf::matched(md_o, secsec, gp.md[rg], gp.ms[rg])
                           : T(1) + secsec;
      }
#pragma unroll
      for (int gb = 0; gb < 2; ++gb) {
        const T ph0 = gp.exists ? cnf::phase(gp, gb) : T(1);
        const T ph1 = cnf::phase(gp, 1 ^ gb);
        F[rp][j][gb] =
            deep_ok ? gf[0] * ph0 + (both ? gf[1] * ph1 : T(0)) : T(1);
        S[rp][j][gb] =
            deep_ok ? gs[0] * ph0 + (both ? gs[1] * ph1 : T(0)) : T(1);
      }
    }
  }
  T PH[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) PH[x] = par.exists ? cnf::phase(par, x) : T(1);

  const int row = (k == 0 ? kPb0 : kPb1) + r0 * 16;
#pragma unroll
  for (int fp = 0; fp < 8; ++fp) {
    const int p0 = fp & 1, gb0 = (fp >> 1) & 1, gb1 = fp >> 2;
#pragma unroll
    for (int sk = 0; sk < 2; ++sk) {
      T acc = T(0);
#pragma unroll
      for (int rp = 0; rp < 2; ++rp) {
        const T g = p0 == 0 ? F[rp][0][gb0] * S[rp][1][gb1]
                            : F[rp][1][gb1] * S[rp][0][gb0];
        acc += A[rp] * PH[rp ^ p0 ^ sk] * g;
      }
      // focal top: ones, so that e = tops through the same products
      s[row + fp * 2 + sk][i] = f.attop ? T(1) : acc;
    }
  }
  if (k == 0) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const T tops = root.froot[0][t] + root.froot[1][t];
      const T fr = r0 ? root.froot[1][t] : root.froot[0][t];
      s[kFroot + r0 * 2 + t][i] = f.attop ? (r0 ? T(0) : tops) : fr;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(4 * Tile<T>::kUnits)
    emission_kernel(const int* __restrict__ md, const T* __restrict__ ms,
                    const T* __restrict__ hw, const int* __restrict__ ex,
                    const int* __restrict__ at, T* __restrict__ e, int M,
                    int R) {
  constexpr int U = Tile<T>::kUnits, V = Tile<T>::kVec;
  constexpr int G = U / V;  // unit groups of a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*s)[U] = reinterpret_cast<T(*)[U]>(smem_raw);
  const int m = blockIdx.y;
  const int r_base = blockIdx.x * U;

  // ---- phase 1: thread (unit i, side k, branch r0), i fastest ----------
  {
    const int i = threadIdx.x % U, role = threadIdx.x / U;
    const int r = r_base + i;
    if (r < R)
      unit_tables<T, U>(md, ms, hw, ex, at, s, i, role >> 1, role & 1, m, r,
                        M, R);
  }
  __syncthreads();

  // ---- phase 2: thread (unit group g, combos c = (t, a)) ----------------
  // R is a multiple of 32, so a group of V <= 4 units is all in or all out
  const int g = threadIdx.x % G;
  const int r = r_base + g * V;
  if (r >= R) return;
  T* out = e + (size_t)m * 512 * R + r;
  const int col = g * V;
#pragma unroll
  for (int n = 0; n < 4 / V; ++n) {
    const int c = threadIdx.x / G + n * 4 * V;
    const int a = c & 7, t = c >> 3;
    T f0[V], f1[V], q[2][2][V];  // q[r0][u] = froot[r0][t] * pbs0[r0][a][u]
    ld(&s[kFroot + t][col], f0);
    ld(&s[kFroot + 2 + t][col], f1);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      T p0[V], p1[V];
      ld(&s[kPb0 + a * 2 + u][col], p0);
      ld(&s[kPb0 + 16 + a * 2 + u][col], p1);
#pragma unroll
      for (int w = 0; w < V; ++w) {
        q[0][u][w] = f0[w] * p0[w];
        q[1][u][w] = f1[w] * p1[w];
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        T b0[V], b1[V];
        ld(&s[kPb1 + b * 2 + v][col], b0);
        ld(&s[kPb1 + 16 + b * 2 + v][col], b1);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          T val[V];
#pragma unroll
          for (int w = 0; w < V; ++w)
            val[w] = q[0][u][w] * b0[w] + q[1][u][w] * b1[w];
          const int x = ((v * 2 + u) * 2 + t) * 64 + b * 8 + a;
          st(out + (size_t)x * R, val);
        }
      }
    }
  }
}

template <typename T>
int launch_emission(const int* md, const T* ms, const T* hw, const int* ex,
                    const int* at, T* e, int M, int R, void* stream) {
  if (M <= 0 || R <= 0) return 0;
  // whole vectors, 16-byte aligned rows (ops/scan.py pads R to 32)
  if (R % 32 != 0) return (int)cudaErrorInvalidValue;
  constexpr int U = Tile<T>::kUnits;
  const size_t smem = sizeof(T) * kRows * U;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        emission_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((R + U - 1) / U, M);
  emission_kernel<T><<<grid, 4 * U, smem, (cudaStream_t)stream>>>(
      md, ms, hw, ex, at, e, M, R);
  return (int)cudaGetLastError();
}

// ---- the [B, M, NS, S] entry ---------------------------------------------
// cnf_emission_bmns_*: everything the classic scan (the one that carries
// coherence) reads from the emission model, in one launch: e [B, M, 8, 64]
// (#5's input; skipped for a null e), froot and top [B, M, 2, 2], and the
// pathful parent blocks pb0, pb1 [B, M, r0, fp, fpath, sk] = [B, M, 2, 8,
// 8, 2] (#10's and the line-origin reporter's input).  Replaces the JAX
// package's XLA program hmm/emission.py:364 build_blocks (standard
// options) + :409 assemble_e_all, which has no TPU kernel.  Reads the
// family batch in place: md, ms [B, 7, M, 2], hw [B, 7, M], exists and
// attop [B, 7] as int.
//
// Bound: bytes, the 1,032 values written a (unit, marker) pair (0.245 ms
// at B=1000, M=192 in float with ~28 MB of slot reads; 0.48 ms in
// double).  Design:
//   1. Phase 1 is the v2 entry's, four threads a pair (side k, branch
//      r0), but keeps the grandparent factors per rg: a pathful entry is
//      the product of one factor per path bit,
//        pb[k][r0][fp][fpath][sk] = A[rp] * PH[rp ^ p0 ^ sk] * G,
//        G = F[r0][rp][0][rg0][gb0] * S[rp][1][rg1][gb1]   (p0 = 0)
//          = F[r0][rp][1][rg1][gb1] * S[rp][0][rg0][gb0]   (p0 = 1),
//      with the canonical-path weights folded into the tables (A = 0 at
//      rp = 1 for a vacant parent; F = S = 0 at rg = 1 where the
//      recursion consumes no grandparent bit; F = S = 1 at rg = 0 for a
//      vacant or founder parent).  The threads also write e's path sums
//      (the v2 entry's, ones for a focal top) and the focal's froot, top
//      and e's root factor.  Each pair's ~184 values form one row of
//      shared memory (odd stride: conflict-free writes).
//   2. The block's threads then stream each output's contiguous run of
//      its pairs, 16 bytes a thread and store, every value a product of
//      a few table entries: whole sectors, no [B, M, 2, 8, 8, 2]
//      temporary, and pb's path sums never leave the block.
constexpr int kBmnsPairs = 32;  // pairs a block, four threads each
// a pair's row: FR [r0][t] froot; TP [r0][t] top; EF [r0][t] e's root
// factor; PS [k][r0][fp][sk] e's path sums; A [k][r0][rp]; PH [k][x];
// F [k][r0][rp][j][rg][gb]; S [k][rp][j][rg][gb]
constexpr int bFR = 0, bTP = 4, bEF = 8, bPS = 12, bA = 76, bPH = 84,
              bF = 88, bS = 152, kBmnsRow = 185;

template <typename T>
struct BmnsVec;  // values a store: 16 bytes
template <>
struct BmnsVec<float> {
  static constexpr int kVec = 4;
};
template <>
struct BmnsVec<double> {
  static constexpr int kVec = 2;
};

__device__ __forceinline__ void st(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

// slot s of unit b at marker m from the family batch's own layout
template <typename T>
__device__ __forceinline__ cnf::Slot<T> load_slot_bmns(
    const int* __restrict__ md, const T* __restrict__ ms,
    const T* __restrict__ hw, const int* __restrict__ ex,
    const int* __restrict__ at, int s, int m, int b, int M) {
  cnf::Slot<T> out;
  const size_t row = (size_t)b * 7 + s;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const size_t i = (row * M + m) * 2 + a;
    out.md[a] = md[i];
    out.ms[a] = ms[i];
  }
  out.hw = hw[row * M + m];
  out.exists = ex[row];
  out.attop = at[row];
  return out;
}

// the focal-as-top term of root branch r0 and root phase s0 (focal value
// unknown, side 0): root_block's bv_abs * ph
template <typename T>
__device__ __forceinline__ T focal_top(const cnf::Slot<T>& f, int r0,
                                       int s0) {
  T bv, pre;
  int bound;
  cnf::match_raw(cnf::kUnknown, T(0), f.md[r0], f.ms[r0], bv, pre, bound);
  const bool collapse = f.md[0] == f.md[1] && f.ms[0] == f.ms[1];
  const T f2n = T(r0 ^ s0);
  return (bv + pre) * (collapse ? f2n : fabs(f2n - f.hw));
}

// Phase 1 for side k, root branch r0 of one pair: its factors into the
// pair's row; side 0's threads also write the focal's rows.
template <typename T>
__device__ __forceinline__ void pair_tables(
    const int* __restrict__ md, const T* __restrict__ ms,
    const T* __restrict__ hw, const int* __restrict__ ex,
    const int* __restrict__ at, T* row, int k, int r0, int m, int b,
    int M) {
  const cnf::Slot<T> f = load_slot_bmns(md, ms, hw, ex, at, 0, m, b, M);
  cnf::Root<T> root;
  cnf::root_block(f, 0, 0, root);
  const cnf::Slot<T> par = load_slot_bmns(md, ms, hw, ex, at, 1 + 3 * k, m,
                                          b, M);
  const cnf::Slot<T> gp0 = load_slot_bmns(md, ms, hw, ex, at, 2 + 3 * k, m,
                                          b, M);
  const cnf::Slot<T> gp1 = load_slot_bmns(md, ms, hw, ex, at, 3 + 3 * k, m,
                                          b, M);
  const int v = k == 0 ? (r0 ? root.vA[1] : root.vA[0])
                       : (r0 ? root.vB[1] : root.vB[0]);
  const T sv = k == 0 ? (r0 ? root.svA[1] : root.svA[0])
                      : (r0 ? root.svB[1] : root.svB[0]);
  const bool deep_ok = par.exists && !par.attop;

  // [rp], [rp][j][rg][gb]; the rg sums [rp][j][gb] for e
  T A[2], F[2][2][2][2], S[2][2][2][2];
#pragma unroll
  for (int rp = 0; rp < 2; ++rp) {
    T bv_raw, pre;
    int bound;
    cnf::match_raw(v, sv, par.md[rp], par.ms[rp], bv_raw, pre, bound);
    const T ms_nab = cnf::safe_div(pre, bv_raw);
    const int md_o = par.md[1 - rp];
    const T ms_o = par.ms[1 - rp];
    const T sec_f = ms_o != T(0) ? T(1) - ms_o : T(1);
    const T secsec = ms_o != T(0) ? cnf::safe_div(ms_o, T(1) - ms_o) : T(0);
    A[rp] = !par.exists ? (rp == 0 ? T(1) + sv : T(0))
            : par.attop ? bv_raw + pre
                        : bv_raw * sec_f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const cnf::Slot<T>& gp = j == 0 ? gp0 : gp1;
#pragma unroll
      for (int rg = 0; rg < 2; ++rg) {
        // the path bit rg = 1 counts only where the recursion consumes it
        const bool live = rg == 0 || gp.exists;
        const T gf = gp.exists ? cnf::matched(bound, ms_nab, gp.md[rg],
                                              gp.ms[rg])
                               : T(1) + ms_nab;
        const T gs = gp.exists ? cnf::matched(md_o, secsec, gp.md[rg],
                                              gp.ms[rg])
                               : T(1) + secsec;
#pragma unroll
        for (int gb = 0; gb < 2; ++gb) {
          const T ph = gp.exists ? cnf::phase(gp, rg ^ gb) : T(1);
          F[rp][j][rg][gb] = !deep_ok ? (rg == 0 ? T(1) : T(0))
                             : live   ? gf * ph
                                      : T(0);
          S[rp][j][rg][gb] = !deep_ok ? (rg == 0 ? T(1) : T(0))
                             : live   ? gs * ph
                                      : T(0);
        }
      }
    }
  }
  T PH[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) PH[x] = par.exists ? cnf::phase(par, x) : T(1);

  const int kr = k * 2 + r0;
#pragma unroll
  for (int rp = 0; rp < 2; ++rp) {
    row[bA + kr * 2 + rp] = A[rp];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = q >> 2, rg = (q >> 1) & 1, gb = q & 1;
      row[bF + (kr * 2 + rp) * 8 + q] = F[rp][j][rg][gb];
      if (r0 == 0) row[bS + (k * 2 + rp) * 8 + q] = S[rp][j][rg][gb];
    }
  }
  if (r0 == 0) {
    row[bPH + k * 2] = PH[0];
    row[bPH + k * 2 + 1] = PH[1];
  }
#pragma unroll
  for (int fp = 0; fp < 8; ++fp) {
    const int p0 = fp & 1, gb0 = (fp >> 1) & 1, gb1 = fp >> 2;
#pragma unroll
    for (int sk = 0; sk < 2; ++sk) {
      T acc = T(0);
#pragma unroll
      for (int rp = 0; rp < 2; ++rp) {
        const T g =
            p0 == 0
                ? (F[rp][0][0][gb0] + F[rp][0][1][gb0]) *
                      (S[rp][1][0][gb1] + S[rp][1][1][gb1])
                : (F[rp][1][0][gb1] + F[rp][1][1][gb1]) *
                      (S[rp][0][0][gb0] + S[rp][0][1][gb0]);
        acc += A[rp] * PH[rp ^ p0 ^ sk] * g;
      }
      // focal top: ones, so that e = tops through the same products
      row[bPS + (kr * 8 + fp) * 2 + sk] = f.attop ? T(1) : acc;
    }
  }
  if (k == 0) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const T fr = r0 ? root.froot[1][t] : root.froot[0][t];
      const T tops = root.froot[0][t] + root.froot[1][t];
      row[bFR + r0 * 2 + t] = fr;
      row[bTP + r0 * 2 + t] = focal_top(f, r0, t);
      row[bEF + r0 * 2 + t] = f.attop ? (r0 ? T(0) : tops) : fr;
    }
  }
}

// Phase 2: the block's pairs' run of one output, N values a pair, V
// consecutive values a thread and store; value(row, y) gives value y of
// the pair whose row it is.
template <int N, int V, typename T, typename Fn>
__device__ __forceinline__ void stream_rows(T* __restrict__ out,
                                            const T* tab, int npairs,
                                            Fn value) {
  const int nv = npairs * (N / V);
  for (int q = threadIdx.x; q < nv; q += blockDim.x) {
    const int y0 = q * V;
    const T* row = tab + (y0 / N) * kBmnsRow;
    T val[V];
#pragma unroll
    for (int w = 0; w < V; ++w) val[w] = value(row, y0 % N + w);
    st(out + y0, val);
  }
}

// pathful entry y = ((r0*8 + fp)*8 + fpath)*2 + sk of side k's block
template <typename T>
__device__ __forceinline__ T pathful(const T* row, int k, int y) {
  const int r0 = y >> 7, fp = (y >> 4) & 7, fpath = (y >> 1) & 7,
            sk = y & 1;
  const int p0 = fp & 1, gb0 = (fp >> 1) & 1, gb1 = fp >> 2;
  const int rp = fpath & 1, rg0 = (fpath >> 1) & 1, rg1 = fpath >> 2;
  const T* F = row + bF + ((k * 2 + r0) * 2 + rp) * 8;  // [j][rg][gb]
  const T* S = row + bS + (k * 2 + rp) * 8;
  const T g = p0 == 0 ? F[rg0 * 2 + gb0] * S[4 + rg1 * 2 + gb1]
                      : F[4 + rg1 * 2 + gb1] * S[rg0 * 2 + gb0];
  return row[bA + (k * 2 + r0) * 2 + rp] * row[bPH + k * 2 + (rp ^ p0 ^ sk)] *
         g;
}

// e at x = ((v*2 + u)*2 + t)*64 + b*8 + a
template <typename T>
__device__ __forceinline__ T e_value(const T* row, int x) {
  const int t = (x >> 6) & 1, u = (x >> 7) & 1, v = x >> 8;
  const int a = x & 7, b = (x >> 3) & 7;
  const T* ps = row + bPS;  // [k][r0][fp][sk]
  return row[bEF + t] * ps[a * 2 + u] * ps[32 + b * 2 + v] +
         row[bEF + 2 + t] * ps[16 + a * 2 + u] * ps[48 + b * 2 + v];
}

template <typename T>
__global__ void __launch_bounds__(4 * kBmnsPairs)
    emission_bmns_kernel(const int* __restrict__ md, const T* __restrict__ ms,
                         const T* __restrict__ hw, const int* __restrict__ ex,
                         const int* __restrict__ at, T* __restrict__ froot,
                         T* __restrict__ top, T* __restrict__ pb0,
                         T* __restrict__ pb1, T* __restrict__ e, int M,
                         long long P) {
  constexpr int U = kBmnsPairs, V = BmnsVec<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const tab = reinterpret_cast<T*>(smem_raw);
  const long long pbase = (long long)blockIdx.x * U;
  const int npairs = (int)(P - pbase < U ? P - pbase : U);

  // ---- phase 1: thread (pair i, side k, branch r0), i fastest ----------
  {
    const int i = threadIdx.x % U, role = threadIdx.x / U;
    if (i < npairs) {
      const long long p = pbase + i;
      pair_tables<T>(md, ms, hw, ex, at, tab + i * kBmnsRow, role >> 1,
                     role & 1, (int)(p % M), (int)(p / M), M);
    }
  }
  __syncthreads();

  // ---- phase 2: each output's contiguous run ---------------------------
  stream_rows<4, V>(froot + pbase * 4, tab, npairs,
                    [](const T* row, int y) { return row[bFR + y]; });
  stream_rows<4, V>(top + pbase * 4, tab, npairs,
                    [](const T* row, int y) { return row[bTP + y]; });
  stream_rows<256, V>(pb0 + pbase * 256, tab, npairs,
                      [](const T* row, int y) { return pathful(row, 0, y); });
  stream_rows<256, V>(pb1 + pbase * 256, tab, npairs,
                      [](const T* row, int y) { return pathful(row, 1, y); });
  if (e != nullptr)
    stream_rows<512, V>(e + pbase * 512, tab, npairs,
                        [](const T* row, int x) { return e_value(row, x); });
}

template <typename T>
int launch_emission_bmns(const int* md, const T* ms, const T* hw,
                         const int* ex, const int* at, T* froot, T* top,
                         T* pb0, T* pb1, T* e, int B, int M, void* stream) {
  if (M <= 0 || B <= 0) return 0;
  constexpr int U = kBmnsPairs;
  const long long P = (long long)B * M;
  const size_t smem = sizeof(T) * kBmnsRow * U;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        emission_bmns_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = (P + U - 1) / U;
  emission_bmns_kernel<T><<<(unsigned)grid, 4 * U, smem,
                            (cudaStream_t)stream>>>(
      md, ms, hw, ex, at, froot, top, pb0, pb1, e, M, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cnf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int cnf_emission_f32(const int* md, const float* ms, const float* hw,
                     const int* ex, const int* at, float* e, int M, int R,
                     void* stream) {
  return launch_emission<float>(md, ms, hw, ex, at, e, M, R, stream);
}

int cnf_emission_f64(const int* md, const double* ms, const double* hw,
                     const int* ex, const int* at, double* e, int M, int R,
                     void* stream) {
  return launch_emission<double>(md, ms, hw, ex, at, e, M, R, stream);
}

int cnf_emission_bmns_f32(const int* md, const float* ms, const float* hw,
                          const int* ex, const int* at, float* froot,
                          float* top, float* pb0, float* pb1, float* e, int B,
                          int M, void* stream) {
  return launch_emission_bmns<float>(md, ms, hw, ex, at, froot, top, pb0, pb1,
                                     e, B, M, stream);
}

int cnf_emission_bmns_f64(const int* md, const double* ms, const double* hw,
                          const int* ex, const int* at, double* froot,
                          double* top, double* pb0, double* pb1, double* e,
                          int B, int M, void* stream) {
  return launch_emission_bmns<double>(md, ms, hw, ex, at, froot, top, pb0,
                                      pb1, e, B, M, stream);
}

}  // extern "C"
