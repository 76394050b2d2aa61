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
// i / 8, a = i % 8) from one marker's tables tab and froot fr, each
// value in the plain twin's order: the sum over r of (F[r, t] L[r, a, u])
// R[r, b', v'], the focal slot's F signed by r ^ t
template <typename T, typename Use>
__device__ __forceinline__ void for_emission(const T (&tab)[kTables][32],
                                             const T (&fr)[4], int v, int lt,
                                             int rt, int j, int t, int u,
                                             int vv, Use use) {
  T f[2], rr[2][2];  // F[r, t]; R[r, 2 j + h, v'] as rr[h][r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    f[r] = fr[r * 2 + t];
    if (v == 1 && (r ^ t)) f[r] = -f[r];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rr[h][r] = tab[rt][r * 16 + (2 * j + h) * 2 + vv];
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const T fl0 = f[0] * tab[lt][a * 2 + u];
    const T fl1 = f[1] * tab[lt][16 + a * 2 + u];
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
    for_emission(sh.tab[q0], sh.froot[q0], v, lt, rt, j, t, u, vv,
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
    for_emission(sh.tab[q1], sh.froot[q1], v, lt, rt, j, t, u, vv,
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

// ---- kernel #14: SELFING's seven-slot coherence -----------------------
//
// Replaces no TPU kernel: the JAX package runs it as XLA
// (cnf2freq_tpu/engine_ext.py:318 coherence_slot_ext, once per slot,
// with hmm/probes.py:608 _phase_resolved_emission).  Plain twin:
// ops/coherence.py::coherence_ext_reference.  Over the extended sweeps
// [B, M, V, NS, S] (V = kV = 3 HBD statuses), per (unit b, marker
// m < M - 1) and for #10's eight emissions E_e (path-summed, then
// parity-signed per slot), each now per extension value v from v's
// blocks:
//   chain_e = sum_s w[s] sum_g < sum_f C[f, g] T_m (fw_pre[m,f,s] .
//             E_e[m,f,s]), E_e[m+1,g,s] . bw[m+1,g,s] >,
// with C[b, m] the interval's [V, V] coupling (row = from).  The twin's
// joint J[i, j] of the phase bit is bilinear in the phase-resolved
// emissions e_0, e_1, and E_0 = e_0 + e_1, E_{1+slot} = e_0 - e_1, so
// same / total = 0.5 + 0.5 chain_{1+slot} / chain_0 where chain_0 > 0,
// else 0.5 (#10's identity: its error is relative to the total); the
// last marker column is 0.5.
// Design: #10's, with V rows a side: a warp a pair, a row in 4 lanes x
// 16 states, the FWHTs' strides 16 and 32 by shuffles; the block's
// path-sum tables of each v built once in shared memory; the rows read
// straight from device memory in 16-byte loads (V x 1024 values a pair
// would not fit a block's shared memory with 4 pairs in f64); per
// emission the V transformed rows of marker m stay in registers for the
// coupling's mix into each row of marker m + 1.
constexpr int kV = 3;

template <typename T>
struct ExtBlocks {  // each extension value's blocks, [B, M, ...] each
  const T* froot[kV];
  const T* pb0[kV];
  const T* pb1[kV];
};

template <typename T>
struct ExtShared {
  alignas(16) T lam[kWarps][64];       // a warp's lam[m] / 64
  T tab[kMarkers][kV][kTables][32];    // [marker][v][table][(r, fp, sk)]
  T froot[kMarkers][kV][4];            // [marker][v][(r, t)]
};

// 16 consecutive values of a row in device memory (16-byte aligned)
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p, T (&v)[16]) {
  using V = typename Vec16<T>::type;
  constexpr int kQuad = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < 16 / kQuad; ++k)
    Vec16<T>::unpack(__ldg(reinterpret_cast<const V*>(p) + k), v + k * kQuad);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    coherence_ext_kernel(const T* __restrict__ fw_pre,
                         const T* __restrict__ bw,
                         const T* __restrict__ fw_pre_f,
                         const T* __restrict__ bw_f,
                         const T* __restrict__ lam,
                         const T* __restrict__ cpl, const ExtBlocks<T> blk,
                         const int* __restrict__ flag2ignore,
                         T* __restrict__ coh, int B, int M) {
  __shared__ ExtShared<T> sh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long BM = (long long)B * M;
  const long long p0 = (long long)blockIdx.x * kWarps;

  // the path-sum tables and froot of each v at the markers p0 .. p0 + kWarps
  for (int task = tid; task < kMarkers * kV * 64; task += kWarps * 32) {
    const int q = task / (kV * 64), v = (task >> 6) % kV;
    const int k = (task >> 5) & 1, e = task & 31;
    const long long bm = p0 + q;
    if (bm >= BM) continue;
    const int f2 = (flag2ignore[bm / M] >> (1 + 3 * k)) & 7;
    T all, par, gp0, gp1;
    path_sums((k ? blk.pb1[v] : blk.pb0[v]) + bm * 256, f2, e, all, par,
              gp0, gp1);
    sh.tab[q][v][k][e] = all;
    sh.tab[q][v][2 + 3 * k][e] = par;
    sh.tab[q][v][3 + 3 * k][e] = gp0;
    sh.tab[q][v][4 + 3 * k][e] = gp1;
  }
  if (tid < kMarkers * kV * 4) {
    const int q = tid / (kV * 4), v = (tid >> 2) % kV, i = tid & 3;
    if (p0 + q < BM) sh.froot[q][v][i] = blk.froot[v][(p0 + q) * 4 + i];
  }

  // this warp's pair and lam[m] / 64
  const long long pair = p0 + warp;
  const bool valid = pair < BM;
  const int m = valid ? (int)(pair % M) : 0;
  const bool chain = valid && m < M - 1;
  if (chain) {
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
  T mx = T(0), mine = T(0);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const T w = fw_pre_f[pair * 8 + k] + bw_f[(pair + 1) * 8 + k];
    mx = (k == 0 || w > mx || w != w) ? w : mx;
    if (k == s) mine = w;
  }
  const T weight = exp(mine - mx);
  T c[kV][kV];  // the coupling of interval m, row = from
  {
    const T* cp = cpl + ((pair / M) * (M - 1) + m) * (kV * kV);
#pragma unroll
    for (int f = 0; f < kV; ++f)
#pragma unroll
      for (int g = 0; g < kV; ++g) c[f][g] = cp[f * kV + g];
  }
  const T* xrow = fw_pre + pair * (kV * 512) + seg * 16;
  const T* yrow = bw + (pair + 1) * (kV * 512) + seg * 16;
  const int q0 = warp, q1 = warp + 1;

  T tot = T(0), corr = T(0);
#pragma unroll 1
  for (int e = 0; e < 8; ++e) {
    const int lt = (e >= 2 && e <= 4) ? e : 0;
    const int rt = e >= 5 ? e : 1;
    T z[kV][16];  // T_m (fw_pre[m, f] . E_e[m, f]) per f
#pragma unroll
    for (int f = 0; f < kV; ++f) {
      load16(xrow + f * 512, z[f]);
      for_emission(sh.tab[q0][f], sh.froot[q0][f], e, lt, rt, j, t, u, vv,
                   [&](int i, T x) { z[f][i] = z[f][i] * x; });
      fwht64_by4(z[f], lane);
      T l[16];
      Segments<T>::load(sh.lam[warp], j, l);
#pragma unroll
      for (int i = 0; i < 16; ++i) z[f][i] *= l[i];
      fwht64_by4(z[f], lane);
    }
    T part = T(0);
#pragma unroll
    for (int g = 0; g < kV; ++g) {
      T y[16];
      load16(yrow + g * 512, y);
      for_emission(sh.tab[q1][g], sh.froot[q1][g], e, lt, rt, j, t, u, vv,
                   [&](int i, T x) {
                     T zt = c[0][g] * z[0][i];
#pragma unroll
                     for (int f = 1; f < kV; ++f) zt += c[f][g] * z[f][i];
                     part = part + zt * (x * y[i]);
                   });
    }
    // the row's 64 states (all V), then its weight, then the shifts
    part += __shfl_xor_sync(cnf::kFullMask, part, 1);
    part += __shfl_xor_sync(cnf::kFullMask, part, 2);
    T sum = weight * part;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      sum += __shfl_xor_sync(cnf::kFullMask, sum, o);
    if (e == 0) tot = sum;
    if (lane == e - 1) corr = sum;
  }
  if (lane < 7) out[lane] = tot > T(0) ? T(0.5) + T(0.5) * corr / tot : T(0.5);
}

template <typename T>
int launch_coherence_ext(const T* fw_pre, const T* bw, const T* fw_pre_f,
                         const T* bw_f, const T* lam, const T* cpl,
                         const ExtBlocks<T>& blk, const int* flag2ignore,
                         T* coh, int B, int M, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const long long pairs = (long long)B * M;
  const unsigned grid = (unsigned)((pairs + kWarps - 1) / kWarps);
  coherence_ext_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      fw_pre, bw, fw_pre_f, bw_f, lam, cpl, blk, flag2ignore, coh, B, M);
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

// kernel #14: fw_pre, bw [B, M, 3, 8, 64], fw_pre_f, bw_f [B, M, 8],
// lam [M-1, 64], cpl [B, M-1, 3, 3], each HBD status v's froot_v
// [B, M, 2, 2] and pb0_v, pb1_v [B, M, 2, 8, 8, 2]; coh [B, M, 7]
int cnf_coherence_ext_f32(const float* fw_pre, const float* bw,
                          const float* fw_pre_f, const float* bw_f,
                          const float* lam, const float* cpl,
                          const float* froot0, const float* froot1,
                          const float* froot2, const float* pb00,
                          const float* pb01, const float* pb02,
                          const float* pb10, const float* pb11,
                          const float* pb12, const int* flag2ignore,
                          float* coh, int B, int M, void* stream) {
  const ExtBlocks<float> blk{{froot0, froot1, froot2}, {pb00, pb01, pb02},
                             {pb10, pb11, pb12}};
  return launch_coherence_ext<float>(fw_pre, bw, fw_pre_f, bw_f, lam, cpl,
                                     blk, flag2ignore, coh, B, M, stream);
}

int cnf_coherence_ext_f64(const double* fw_pre, const double* bw,
                          const double* fw_pre_f, const double* bw_f,
                          const double* lam, const double* cpl,
                          const double* froot0, const double* froot1,
                          const double* froot2, const double* pb00,
                          const double* pb01, const double* pb02,
                          const double* pb10, const double* pb11,
                          const double* pb12, const int* flag2ignore,
                          double* coh, int B, int M, void* stream) {
  const ExtBlocks<double> blk{{froot0, froot1, froot2}, {pb00, pb01, pb02},
                              {pb10, pb11, pb12}};
  return launch_coherence_ext<double>(fw_pre, bw, fw_pre_f, bw_f, lam, cpl,
                                      blk, flag2ignore, coh, B, M, stream);
}

}  // extern "C"
