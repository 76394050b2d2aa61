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
// emission is stored: the eight (L, R) tables of a marker live in shared
// memory (entry (r, fp, sk) of each) and the emissions in registers.
//
// Bound on the H100: memory, barely.  A pair reads fw_pre[m], bw[m+1]
// and the blocks once (3 x 512 values and 20 more; ~1.2 GB at B = 1000,
// M = 192 in float32); the operations (~102,000 a pair: 64 (emission,
// shift) chains of two 64-point FWHTs, the emissions and the dot
// product) are ~20 GFLOP.  In practice the card's issue rate and its
// shuffles bound it: a row held by a whole warp, two states a lane, would
// take ~1,300 warp shuffles a pair.  Design:
//   - a block covers kWarps consecutive (unit, marker) pairs, a warp a
//     pair; the block builds the path-sum tables of the kWarps + 1 markers
//     they span once, in shared memory;
//   - a warp stages its pair's fw_pre[m] and bw[m+1] rows (coalesced) and
//     lam[m] / 64 in shared memory once, then runs its 64 (emission,
//     shift) rows eight at a time: lanes 4s .. 4s + 3 hold shift s's row,
//     16 states a lane (state j * 16 + i in lane 4s + j);
//   - an FWHT runs its four strides 1-8 inside the thread and only the
//     strides 16 and 32 by shuffles: 8 warp shuffles a row for the two
//     transforms (20 with two states a lane);
//   - a lane builds its 16 emission values in the plain twin's order (the
//     root times the left block, times the right one) and sums a row's 64
//     states before its shift weight, then the shifts, as the twin does:
//     the float64 cuda-vs-CPU parity of relhaplo stays below 2e-15;
//   - it reads its rows and lam from shared memory with 16-byte loads in
//     a swizzled order that puts a quarter-warp's reads on distinct banks.
// The 1/64 of T_m rides in the staged lam (a power of two: the same
// values), so both transforms and their scalings stay on the left side.
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

constexpr int kWarps = 4;               // pairs a block
constexpr int kMarkers = kWarps + 1;    // markers the block's pairs span
constexpr int kTables = 8;  // path sums of blocks 0 and 1, then the parity
                            // sums (parent, grandparent 0, grandparent 1)
                            // of block 0, then of block 1

template <typename T>
struct Vec16;  // 16 bytes of T
template <>
struct Vec16<float> {
  using type = float4;
  __device__ static void unpack(const float4& q, float* d) {
    d[0] = q.x;
    d[1] = q.y;
    d[2] = q.z;
    d[3] = q.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  __device__ static void unpack(const double2& q, double* d) {
    d[0] = q.x;
    d[1] = q.y;
  }
};

// 64-state rows in shared memory as segments of 16 states; a segment's
// 16-byte quads are stored in a swizzled order, so that the 16-byte reads
// of 8 consecutive segments (a quarter-warp's lanes) fall on 8 distinct
// groups of 4 banks
template <typename T>
struct Segments {
  static constexpr int kQuad = 16 / sizeof(T);       // states a quad
  static constexpr int kQuads = 16 / kQuad;          // quads a segment
  static constexpr int kPerLine = 8 / kQuads;        // segments a 128 B
  __device__ static int at(int seg, int w) {
    const int swz = (seg / kPerLine) & (kQuads - 1);
    return seg * 16 + ((w / kQuad) ^ swz) * kQuad + w % kQuad;
  }
  // the 16 states of segment seg
  __device__ static void load(const T* row, int seg, T (&v)[16]) {
    using V = typename Vec16<T>::type;
#pragma unroll
    for (int k = 0; k < kQuads; ++k)
      Vec16<T>::unpack(
          *reinterpret_cast<const V*>(row + at(seg, k * kQuad)),
          v + k * kQuad);
  }
};

template <typename T>
struct BlockShared {
  alignas(16) T rows[kWarps][2][512];  // a warp's fw_pre[m], bw[m + 1]
  alignas(16) T lam[kWarps][64];       // a warp's lam[m] / 64
  T tab[kMarkers][kTables][32];        // [marker][table][(r, fp, sk)]
  T froot[kMarkers][4];                // [marker][(r, t)]
};

// entry (r, fp, sk): block k's sum over the canonical paths (those with
// no bit of f2 set), plain and signed by each phase-bit parity: the
// parent's ((fpath ^ fp) & 1) ^ sk, grandparent j's bit 1 + j of
// fpath ^ fp
template <typename T>
__device__ __forceinline__ void path_sums(const T* __restrict__ pb, int f2,
                                          int entry, T& all, T& par, T& gp0,
                                          T& gp1) {
  const int fp = (entry >> 1) & 7, sk = entry & 1;
  const T* row = pb + (entry >> 4) * 128 + fp * 16 + sk;
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

// unnormalised 64-point Walsh-Hadamard transform of a row held by 4 lanes
// (lane bits 0-1 = state bits 4-5), 16 states a lane: strides 1-8 inside
// the thread, 16 and 32 by shuffles
template <typename T>
__device__ __forceinline__ void fwht64_by4(T (&x)[16], int lane) {
#pragma unroll
  for (int h = 1; h < 16; h <<= 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i & h) continue;
      const T a = x[i], b = x[i + h];
      x[i] = a + b;
      x[i + h] = a - b;
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const T sgn = (lane & o) ? T(-1) : T(1);  // upper: partner - own
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const T p = __shfl_xor_sync(cnf::kFullMask, x[i], o);
      x[i] = p + sgn * x[i];
    }
  }
}

// use(i, E_v[m, s, state 16 j + i]) for the lane's 16 states (b' = 2 j +
// i / 8, a = i % 8) at table marker q, each value in the plain twin's
// order: the sum over r of (F[r, t] L[r, a, u]) R[r, b', v'], the focal
// slot's F signed by r ^ t
template <typename T, typename Use>
__device__ __forceinline__ void for_emission(const BlockShared<T>& sh, int q,
                                             int v, int lt, int rt, int j,
                                             int t, int u, int vv, Use use) {
  T f[2], rr[2][2];  // F[r, t]; R[r, 2 j + h, v'] as rr[h][r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    f[r] = sh.froot[q][r * 2 + t];
    if (v == 1 && (r ^ t)) f[r] = -f[r];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rr[h][r] = sh.tab[q][rt][r * 16 + (2 * j + h) * 2 + vv];
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const T fl0 = f[0] * sh.tab[q][lt][a * 2 + u];
    const T fl1 = f[1] * sh.tab[q][lt][16 + a * 2 + u];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      use(h * 8 + a, fl0 * rr[h][0] + fl1 * rr[h][1]);
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
  __shared__ BlockShared<T> sh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long BM = (long long)B * M;
  const long long p0 = (long long)blockIdx.x * kWarps;

  // the path-sum tables and froot of the markers p0 .. p0 + kWarps
  for (int task = tid; task < kMarkers * 64; task += kWarps * 32) {
    const int q = task >> 6, k = (task >> 5) & 1, e = task & 31;
    const long long bm = p0 + q;
    if (bm >= BM) continue;
    const int f2 = (flag2ignore[bm / M] >> (1 + 3 * k)) & 7;
    T all, par, gp0, gp1;
    path_sums((k ? pb1 : pb0) + bm * 256, f2, e, all, par, gp0, gp1);
    sh.tab[q][k][e] = all;
    sh.tab[q][2 + 3 * k][e] = par;
    sh.tab[q][3 + 3 * k][e] = gp0;
    sh.tab[q][4 + 3 * k][e] = gp1;
  }
  if (tid < kMarkers * 4 && p0 + (tid >> 2) < BM)
    sh.froot[tid >> 2][tid & 3] = froot[(p0 + (tid >> 2)) * 4 + (tid & 3)];

  // this warp's pair: its rows and lam[m] / 64
  const long long pair = p0 + warp;
  const bool valid = pair < BM;
  const int m = valid ? (int)(pair % M) : 0;
  const bool chain = valid && m < M - 1;
  if (chain) {
    const T* xs = fw_pre + pair * 512;
    const T* ys = bw + (pair + 1) * 512;
#pragma unroll 4
    for (int n = 0; n < 16; ++n) {
      const int e = n * 32 + lane;
      const int at = Segments<T>::at(e >> 4, e & 15);
      sh.rows[warp][0][at] = xs[e];
      sh.rows[warp][1][at] = ys[e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = lane + 32 * h;
      sh.lam[warp][Segments<T>::at(g >> 4, g & 15)] =
          lam[(size_t)m * 64 + g] * T(1.0 / 64.0);
    }
  }
  __syncthreads();
  if (!valid) return;
  T* out = coh + pair * 7;
  if (!chain) {
    if (lane < 7) out[lane] = T(0.5);
    return;
  }

  const int s = lane >> 2, j = lane & 3;
  const int t = s & 1, u = (s >> 1) & 1, vv = s >> 2;
  const int seg = s * 4 + j;  // this lane's 16 states of row s
  // shift weights (a NaN factor propagates through the max, as in torch)
  T mx = T(0), mine = T(0);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const T w = fw_pre_f[pair * 8 + k] + bw_f[(pair + 1) * 8 + k];
    mx = (k == 0 || w > mx || w != w) ? w : mx;
    if (k == s) mine = w;
  }
  const T weight = exp(mine - mx);
  const T* xrow = sh.rows[warp][0];
  const T* yrow = sh.rows[warp][1];
  const int q0 = warp, q1 = warp + 1;  // the pair's markers in the tables

  T tot = T(0), corr = T(0);
#pragma unroll 1
  for (int v = 0; v < 8; ++v) {
    // the emission's tables: slots 1-3 sign block 0, slots 4-6 block 1
    const int lt = (v >= 2 && v <= 4) ? v : 0;
    const int rt = v >= 5 ? v : 1;
    T x[16];
    Segments<T>::load(xrow, seg, x);
    for_emission(sh, q0, v, lt, rt, j, t, u, vv,
                 [&](int i, T e) { x[i] = x[i] * e; });
    fwht64_by4(x, lane);
    {
      T l[16];
      Segments<T>::load(sh.lam[warp], j, l);
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] *= l[i];
    }
    fwht64_by4(x, lane);
    T y[16];
    Segments<T>::load(yrow, seg, y);
    T part = T(0);
    for_emission(sh, q1, v, lt, rt, j, t, u, vv,
                 [&](int i, T e) { part = part + x[i] * e * y[i]; });
    // as the twin sums: the row's 64 states, then its weight, then the
    // shifts
    part += __shfl_xor_sync(cnf::kFullMask, part, 1);
    part += __shfl_xor_sync(cnf::kFullMask, part, 2);
    T sum = weight * part;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      sum += __shfl_xor_sync(cnf::kFullMask, sum, o);
    if (v == 0) tot = sum;
    if (lane == v - 1) corr = sum;
  }
  if (lane < 7) out[lane] = tot > T(0) ? T(0.5) + T(0.5) * corr / tot : T(0.5);
}

template <typename T>
int launch_coherence(const T* fw_pre, const T* bw, const T* fw_pre_f,
                     const T* bw_f, const T* lam, const T* froot,
                     const T* pb0, const T* pb1, const int* flag2ignore,
                     T* coh, int B, int M, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const long long pairs = (long long)B * M;
  const unsigned grid = (unsigned)((pairs + kWarps - 1) / kWarps);
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
