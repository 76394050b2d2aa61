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

}  // extern "C"
