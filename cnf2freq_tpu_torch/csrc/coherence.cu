// Adjacent-marker phase coherence of the classic scan: all seven slots'
// pair chains and their shared total in one launch.
//
// Replaces no TPU kernel: the JAX package runs this stage as XLA
// (cnf2freq_tpu/hmm/probes.py:662-776: pair_chain,
// _phase_parity_emission, phase_pair_total, phase_coherence_slot,
// phase_coherence; its resident Driver jits it whole), and the port has
// no XLA.  Plain twin: hmm/probes.py::phase_coherence_reference.
//
// Per (unit b, marker m < M - 1) and for eight emissions E_v, the
// path-summed one (v = 0) and the parity-signed one of each slot
// (v = 1 + slot):
//   chain_v = sum_s w[s] <T_m (fw_pre[m,s] . E_v[m,s]),
//                         E_v[m+1,s] . bw[m+1,s]>
// with w[s] = exp(fw_pre_f[m,s] + bw_f[m+1,s] - max over s) and
// T_m = H diag(lam[m]) H / 64, the twin's apply_transition (both
// transforms on the left side, as the twin takes them: its error stays
// relative to chain_0 even where the parity terms cancel).  Then
// C[b, m, slot] = 0.5 + 0.5 chain_{1+slot} / chain_0 where chain_0 > 0,
// else 0.5; the last marker column is 0.5.
//
// E_v[m, s, g] = sum_r F_v[r, t] L_v[r, a, u] R_v[r, b', v'] with shift
// s = (v', u, t) and state g = (b', a) (the twin's _branch_emission); F
// is froot (sign-flipped where r ^ t for the focal slot), L and R are
// parent blocks 0 and 1 [r, fp, sk] summed over the canonical paths of
// flag2ignore, plain or signed by the slot's phase-bit parity.  No
// emission is stored: each warp builds its two markers' eight (L, R)
// tables in shared memory (lane l: entry (r, fp, sk) = l of each) and
// the emissions in registers.
//
// Bound on the H100: memory, barely.  A pair reads fw_pre[m], bw[m+1]
// and the blocks once (3 x 512 values and 20 more; ~1.2 GB at B = 1000,
// M = 192 in float32); the operations (~102,000 a pair: 64 (emission,
// shift) chains of two 64-point FWHTs, the emissions and the dot
// product) are ~20 GFLOP.  Design: a warp per (unit, marker), lane l
// holding states l and l + 32 of a row; the FWHTs are the sweeps'
// warp-shuffle butterflies (csrc/warp.cuh), so the shuffles, ~1,300 a
// pair in float32 and twice that in float64, are what a first form
// spends its time on.  The emission loop is not unrolled (its tables
// are picked from shared memory), the shift loop is, so the eight rows
// of fw_pre and bw are read from L1 once an emission.
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTables = 8;  // path sums of blocks 0 and 1, then the parity
                            // sums (parent, grandparent 0, grandparent 1)
                            // of block 0, then of block 1

template <typename T>
struct WarpTables {
  T tab[2][kTables][32];  // [marker m, m + 1][table][(r, fp, sk)]
  T froot[2][4];          // [marker][(r, t)]
  T chain[8];
};

// lane (r, fp, sk): block k's sum over the canonical paths (those with
// no bit of f2 set), plain and signed by each phase-bit parity: the
// parent's ((fpath ^ fp) & 1) ^ sk, grandparent j's bit 1 + j of
// fpath ^ fp
template <typename T>
__device__ __forceinline__ void path_sums(const T* __restrict__ pb, int f2,
                                          int lane, T& all, T& par, T& gp0,
                                          T& gp1) {
  const int fp = (lane >> 1) & 7, sk = lane & 1;
  const T* row = pb + (lane >> 4) * 128 + fp * 16 + sk;
  all = par = gp0 = gp1 = T(0);
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (p & f2) continue;
    const T v = row[p * 2];
    const int x = p ^ fp;
    all += v;
    par += (((x & 1) ^ sk) != 0) ? -v : v;
    gp0 += (x & 2) ? -v : v;
    gp1 += (x & 4) ? -v : v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    coherence_kernel(const T* __restrict__ fw_pre, const T* __restrict__ bw,
                     const T* __restrict__ fw_pre_f,
                     const T* __restrict__ bw_f, const T* __restrict__ lam,
                     const T* __restrict__ froot, const T* __restrict__ pb0,
                     const T* __restrict__ pb1,
                     const int* __restrict__ flag2ignore,
                     T* __restrict__ coh, int B, int M) {
  __shared__ WarpTables<T> shared[kWarps];
  const int lane = threadIdx.x & 31;
  WarpTables<T>& sh = shared[threadIdx.x >> 5];
  const long long pair = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= (long long)B * M) return;
  const int b = (int)(pair / M), m = (int)(pair % M);
  T* out = coh + (size_t)pair * 7;
  if (m == M - 1) {
    if (lane < 7) out[lane] = T(0.5);
    return;
  }

  const int f2 = flag2ignore[b];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const size_t bm = (size_t)pair + q;  // (b, m + q)
    path_sums(pb0 + bm * 256, (f2 >> 1) & 7, lane, sh.tab[q][0][lane],
              sh.tab[q][2][lane], sh.tab[q][3][lane], sh.tab[q][4][lane]);
    path_sums(pb1 + bm * 256, (f2 >> 4) & 7, lane, sh.tab[q][1][lane],
              sh.tab[q][5][lane], sh.tab[q][6][lane], sh.tab[q][7][lane]);
    if (lane < 4) sh.froot[q][lane] = froot[bm * 4 + lane];
  }

  // shift weights (a NaN factor propagates through the max, as in torch)
  T w[8];
  T mx = T(0);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    w[s] = fw_pre_f[(size_t)pair * 8 + s] + bw_f[((size_t)pair + 1) * 8 + s];
    mx = (s == 0 || w[s] > mx || w[s] != w[s]) ? w[s] : mx;
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) w[s] = exp(w[s] - mx);
  const T lam_lo = lam[(size_t)m * 64 + lane];
  const T lam_hi = lam[(size_t)m * 64 + lane + 32];
  const T* xrow = fw_pre + (size_t)pair * 512;
  const T* yrow = bw + ((size_t)pair + 1) * 512;
  const int a = lane & 7, blo = lane >> 3, bhi = blo + 4;
  __syncwarp();

#pragma unroll 1
  for (int v = 0; v < 8; ++v) {
    // the emission's tables: slots 1-3 sign block 0, slots 4-6 block 1
    const int lt = (v >= 2 && v <= 4) ? v : 0;
    const int rt = v >= 5 ? v : 1;
    T FL[2][2][2][2];  // [marker][r][t][u]: F[r, t] * L[r, a, u]
    T RV[2][2][2][2];  // [marker][r][b' = blo, bhi][v']: R[r, b', v']
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          T f = sh.froot[q][r * 2 + t];
          if (v == 1 && (r ^ t)) f = -f;  // the focal slot's parity
#pragma unroll
          for (int u = 0; u < 2; ++u)
            FL[q][r][t][u] = f * sh.tab[q][lt][r * 16 + a * 2 + u];
        }
#pragma unroll
        for (int vv = 0; vv < 2; ++vv) {
          RV[q][r][0][vv] = sh.tab[q][rt][r * 16 + blo * 2 + vv];
          RV[q][r][1][vv] = sh.tab[q][rt][r * 16 + bhi * 2 + vv];
        }
      }
    }
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int t = s & 1, u = (s >> 1) & 1, vv = s >> 2;
      T e[2][2];  // [marker][lo, hi]
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          e[q][h] = FL[q][0][t][u] * RV[q][0][h][vv] +
                    FL[q][1][t][u] * RV[q][1][h][vv];
      T xlo = xrow[s * 64 + lane] * e[0][0];
      T xhi = xrow[s * 64 + lane + 32] * e[0][1];
      cnf::fwht64(xlo, xhi, lane);
      xlo *= lam_lo;
      xhi *= lam_hi;
      cnf::fwht64(xlo, xhi, lane);
      xlo *= T(1.0 / 64.0);
      xhi *= T(1.0 / 64.0);
      const T ylo = e[1][0] * yrow[s * 64 + lane];
      const T yhi = e[1][1] * yrow[s * 64 + lane + 32];
      acc += w[s] * (xlo * ylo + xhi * yhi);
    }
    acc = cnf::warp_sum(acc);
    if (lane == 0) sh.chain[v] = acc;
  }
  __syncwarp();
  if (lane < 7) {
    const T tot = sh.chain[0], corr = sh.chain[1 + lane];
    out[lane] = tot > T(0) ? T(0.5) + T(0.5) * corr / tot : T(0.5);
  }
}

template <typename T>
int launch_coherence(const T* fw_pre, const T* bw, const T* fw_pre_f,
                     const T* bw_f, const T* lam, const T* froot,
                     const T* pb0, const T* pb1, const int* flag2ignore,
                     T* coh, int B, int M, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const long long warps = (long long)B * M;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  coherence_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      fw_pre, bw, fw_pre_f, bw_f, lam, froot, pb0, pb1, flag2ignore, coh, B,
      M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cnf_coherence_f32(const float* fw_pre, const float* bw,
                      const float* fw_pre_f, const float* bw_f,
                      const float* lam, const float* froot, const float* pb0,
                      const float* pb1, const int* flag2ignore, float* coh,
                      int B, int M, void* stream) {
  return launch_coherence<float>(fw_pre, bw, fw_pre_f, bw_f, lam, froot, pb0,
                                 pb1, flag2ignore, coh, B, M, stream);
}

int cnf_coherence_f64(const double* fw_pre, const double* bw,
                      const double* fw_pre_f, const double* bw_f,
                      const double* lam, const double* froot,
                      const double* pb0, const double* pb1,
                      const int* flag2ignore, double* coh, int B, int M,
                      void* stream) {
  return launch_coherence<double>(fw_pre, bw, fw_pre_f, bw_f, lam, froot,
                                  pb0, pb1, flag2ignore, coh, B, M, stream);
}

}  // extern "C"
