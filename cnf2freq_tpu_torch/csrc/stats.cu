// Posterior update statistics per (marker, unit) pair.
//
// Replaces the TPU kernel cnf2freq_tpu/ops/stats_pallas.py::_kernel (body
// stats_tile), launched on the main path by ops/scan_v2.py::stats_from_v2.
// Per pair (m, r) with probe rules off:
//   W[b,a,v,u,t] = fw_pre * bw * exp(fw_pre_f + bw_f - total) * allowed,
//   the root and masked parent blocks PBm[k][r0][fp][fpath][sk],
//   the side collapses T1 (branch 1 folded) and T0 (branch 0 folded),
//   haplo b12 [7][2], infprob accum [7][2][2] (GENOSPROBE shares of the
//   focal's allele values 1 and 2 on either root side) and pair [2][2].
// Outputs are written straight in the [B, M, ...] layout.
//
// Two entries share the kernel body, which reads its inputs through a
// layout (index arithmetic only, no transposed copies):
//   cnf_stats_*       the v2 layout of ops/scan.py: slot tensors
//                     [7,2,M,R], sweeps [M,512,R], factors [M,8,R];
//                     consecutive warps take consecutive units of one
//                     marker;
//   cnf_stats_bmns_*  the [B,M,NS,S] layout of the coherence-carrying
//                     scan (replaces the same TPU kernel behind its own
//                     launcher, stats_pallas.py::stats_pallas): family
//                     batch fields [B,7,M,2] / [B,7,M] / [B,7], sweeps
//                     [B,M,512], factors [B,M,8]; consecutive warps take
//                     consecutive markers of one unit, so a warp reads
//                     its pair's 512 sweep values contiguously.
//
// Bound on the H100: the 2 x 512 sweep values read per pair (~1.6 GB at
// M=192, R=1024 in f32) plus ~20k flops of block math per pair, which
// puts it near the balance point; the TPU tile kept ~24 KB live per pair,
// far beyond one thread's registers.  Design: one warp per pair; the
// per-pair tensors (W, the masked blocks, the two allele-value blocks,
// side collapses and pair shares: 1984 values) live in the warp's slice
// of shared memory, each stage is a lane-strided loop over its index
// space separated by __syncwarp, and the scalar results are warp-shuffle
// reductions.  Consecutive warps of a block take consecutive units of one
// marker, so the block's loads of one feature row share cache sectors.
#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

constexpr int kWarps = 4;

// index arithmetic of the v2 layout (R = padded batch, B real units)
struct V2Layout {
  int M, R, B;
  __device__ void pair(long long p, int& m, int& r) const {
    m = (int)(p / B);
    r = (int)(p % B);
  }
  __device__ size_t md(int s, int a, int m, int r) const {
    return ((size_t)(s * 2 + a) * M + m) * R + r;
  }
  __device__ size_t hw(int s, int m, int r) const {
    return ((size_t)s * M + m) * R + r;
  }
  __device__ size_t ex(int s, int r) const { return (size_t)s * R + r; }
  // sweep value x of pair (m, r) is sweep(m, r) + x * xstride()
  __device__ size_t sweep(int m, int r) const {
    return (size_t)m * 512 * R + r;
  }
  __device__ size_t xstride() const { return R; }
  __device__ size_t fac(int m, int n, int r) const {
    return ((size_t)m * 8 + n) * R + r;
  }
};

// index arithmetic of the [B, M, NS, S] layout
struct BMNSLayout {
  int M, B;
  __device__ void pair(long long p, int& m, int& r) const {
    r = (int)(p / M);
    m = (int)(p % M);
  }
  __device__ size_t md(int s, int a, int m, int r) const {
    return (((size_t)r * 7 + s) * M + m) * 2 + a;
  }
  __device__ size_t hw(int s, int m, int r) const {
    return ((size_t)r * 7 + s) * M + m;
  }
  __device__ size_t ex(int s, int r) const { return (size_t)r * 7 + s; }
  __device__ size_t sweep(int m, int r) const {
    return ((size_t)r * M + m) * 512;
  }
  __device__ size_t xstride() const { return 1; }
  __device__ size_t fac(int m, int n, int r) const {
    return ((size_t)r * M + m) * 8 + n;
  }
};

template <typename T, class L>
__device__ __forceinline__ cnf::Slot<T> load_slot(
    const int* md, const T* ms, const T* hw, const int* ex, const int* at,
    int s, int m, int r, const L& lay) {
  cnf::Slot<T> out;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const size_t i = lay.md(s, a, m, r);
    out.md[a] = md[i];
    out.ms[a] = ms[i];
  }
  out.hw = hw[lay.hw(s, m, r)];
  out.exists = ex[lay.ex(s, r)];
  out.attop = at[lay.ex(s, r)];
  return out;
}

template <typename T>
struct Scratch {
  T W[512];     // x order: ((v*2+u)*2+t)*64 + b*8 + a
  T PB[512];    // masked parent blocks [k][r][f][p][s]
  T PBP[512];   // unmasked allele-value blocks [mvi][r][a][p][u]
  T PBq[64];    // path-summed masked blocks [k][r][f][s]
  T T1[64];     // [r][a][u][t]
  T T0[64];     // [r][b][v][t]
  T P0[128];    // [mvi][r][a][u][t]
  T P1[128];    // [mvi][r][b][v][t]
  T wexp[8];
  cnf::Slot<T> sl[7];
  cnf::Root<T> root;
  cnf::Root<T> rootmv[2];
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T Wat(const Scratch<T>& s, int b, int a, int v,
                                 int u, int t) {
  return s.W[((v * 2 + u) * 2 + t) * 64 + b * 8 + a];
}

template <typename T, class L>
__global__ void __launch_bounds__(kWarps * 32)
    stats_kernel(const int* __restrict__ md, const T* __restrict__ ms,
                 const T* __restrict__ hw, const int* __restrict__ ex,
                 const int* __restrict__ at, const int* __restrict__ f2,
                 const int* __restrict__ sh, const T* __restrict__ fw_pre,
                 const T* __restrict__ bw, const T* __restrict__ fw_pre_f,
                 const T* __restrict__ bw_f, const T* __restrict__ total,
                 T* __restrict__ b12_out, T* __restrict__ acc_out,
                 T* __restrict__ pair_out, const L lay) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Scratch<T>& s = reinterpret_cast<Scratch<T>*>(smem_raw)[warp];
  const long long pair = (long long)blockIdx.x * kWarps + warp;
  const int M = lay.M;
  if (pair >= (long long)M * lay.B) return;
  int m, r;
  lay.pair(pair, m, r);
  const size_t stride = lay.xstride();

  // ---- inputs --------------------------------------------------------
  if (lane < 7) s.sl[lane] = load_slot(md, ms, hw, ex, at, lane, m, r, lay);
  const int f2ig = f2[r];
  if (lane < 8) {
    const size_t fi = lay.fac(m, lane, r);
    const T allowed = (lane & sh[r]) == 0 ? T(1) : T(0);
    s.wexp[lane] = exp(fw_pre_f[fi] + bw_f[fi] - total[r]) * allowed;
  }
  __syncwarp();
  if (lane == 0) {
    cnf::root_block(s.sl[0], 0, 0, s.root);
  } else if (lane < 3) {
    // allele-value roots of the first side (redone for the second below)
    cnf::root_block(s.sl[0], lane, 0, s.rootmv[lane - 1]);
  }
  const size_t base = lay.sweep(m, r);
  for (int x = lane; x < 512; x += 32)
    s.W[x] = fw_pre[base + x * stride] * bw[base + x * stride] * s.wexp[x >> 6];
  __syncwarp();

  // ---- masked parent blocks -----------------------------------------
  for (int i = lane; i < 512; i += 32) {
    const int sk = i & 1, p = (i >> 1) & 7, f = (i >> 4) & 7,
              rr = (i >> 7) & 1, k = i >> 8;
    const int bits = (f2ig >> (1 + 3 * k)) & 7;
    T val = T(0);
    if ((bits & p) == 0) {
      const int v = k == 0 ? s.root.vA[rr] : s.root.vB[rr];
      const T sv = k == 0 ? s.root.svA[rr] : s.root.svB[rr];
      val = cnf::parent_term(s.sl[1 + 3 * k], s.sl[2 + 3 * k],
                             s.sl[3 + 3 * k], v, sv, f, p, sk);
    }
    s.PB[i] = val;
  }
  __syncwarp();
  for (int i = lane; i < 64; i += 32) {
    // i = ((k*2 + r)*8 + f)*2 + sk
    const int sk = i & 1, kf = i >> 1;
    T acc = T(0);
    for (int p = 0; p < 8; ++p) acc += s.PB[(kf * 8 + p) * 2 + sk];
    s.PBq[i] = acc;
  }
  __syncwarp();

  // ---- side collapses -----------------------------------------------
  for (int i = lane; i < 128; i += 32) {
    const int t = i & 1, u = (i >> 1) & 1, a = (i >> 2) & 7,
              rr = (i >> 5) & 1;
    T acc = T(0);
    if (i < 64) {
      // T1[r,a,u,t] = sum_{b,v} PBq[1][r][b][v] * W[b,a,v,u,t]
      for (int b = 0; b < 8; ++b)
        for (int v = 0; v < 2; ++v)
          acc += s.PBq[((2 + rr) * 8 + b) * 2 + v] * Wat(s, b, a, v, u, t);
      s.T1[i] = acc;
    } else {
      // T0[r,b,v,t] = sum_{a,u} PBq[0][r][a][u] * W[b,a,v,u,t]
      const int bb = a, vv = u;
      for (int aa = 0; aa < 8; ++aa)
        for (int uu = 0; uu < 2; ++uu)
          acc += s.PBq[(rr * 8 + aa) * 2 + uu] * Wat(s, bb, aa, vv, uu, t);
      s.T0[i - 64] = acc;
    }
  }
  __syncwarp();

  const T fr[2][2] = {{s.root.froot[0][0], s.root.froot[0][1]},
                      {s.root.froot[1][0], s.root.froot[1][1]}};

  // ---- haplo stats --------------------------------------------------
  // focal: F[r,t] = sum_{a,u} pbs0[r,a,u] * T1[r,a,u,t]
  T foc0 = T(0), foc1 = T(0);
  if (lane < 4) {
    const int rr = lane >> 1, t = lane & 1;
    T F = T(0);
    for (int a = 0; a < 8; ++a)
      for (int u = 0; u < 2; ++u)
        F += s.PBq[(rr * 8 + a) * 2 + u] * s.T1[((rr * 8 + a) * 2 + u) * 2 + t];
    const T fF = fr[rr][t] * F;
    if ((rr ^ t) == 0) foc0 = fF; else foc1 = fF;
  }
  // parent k and its grandparents: Y[f,p,s] moments, projected on the
  // phase bits rp^p0^sk (parent) and rg_j^gb_j (grandparent j)
  T h[2][3][2] = {};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = lane + 32 * j;
    const int k = j >> 2;  // i >> 7
    const int sk = i & 1, p = (i >> 1) & 7, f = (i >> 4) & 7;
    const T* Tk = k == 0 ? s.T1 : s.T0;
    T y = T(0);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        y += fr[rr][t] * s.PB[(((k * 2 + rr) * 8 + f) * 8 + p) * 2 + sk] *
             Tk[((rr * 8 + f) * 2 + sk) * 2 + t];
    const int jp = (p & 1) ^ (f & 1) ^ sk;
    const int jg0 = ((p >> 1) & 1) ^ ((f >> 1) & 1);
    const int jg1 = ((p >> 2) & 1) ^ ((f >> 2) & 1);
    h[k][0][0] += jp ? T(0) : y;
    h[k][0][1] += jp ? y : T(0);
    h[k][1][0] += jg0 ? T(0) : y;
    h[k][1][1] += jg0 ? y : T(0);
    h[k][2][0] += jg1 ? T(0) : y;
    h[k][2][1] += jg1 ? y : T(0);
  }
  foc0 = warp_sum(foc0);
  foc1 = warp_sum(foc1);
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) h[k][q][jj] = warp_sum(h[k][q][jj]);
  if (lane == 0) {
    T* o = b12_out + ((size_t)r * M + m) * 14;
    o[0] = foc0;
    o[1] = foc1;
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        o[(1 + 3 * k + q) * 2 + 0] = h[k][q][0];
        o[(1 + 3 * k + q) * 2 + 1] = h[k][q][1];
      }
  }

  // ---- infprob stats and pair shares --------------------------------
  T acc[7][2][2] = {};
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    if (side == 1) {
      __syncwarp();
      if (lane >= 1 && lane < 3)
        cnf::root_block(s.sl[0], lane, 1, s.rootmv[lane - 1]);
    }
    __syncwarp();
    const int ps = 1 + 3 * side;
    // PBP[mvi][r][a][p][u]: parent block of `side` fed by the root's
    // allele-value branch (unmasked)
    for (int i = lane; i < 512; i += 32) {
      const int u = i & 1, p = (i >> 1) & 7, a = (i >> 4) & 7,
                rr = (i >> 7) & 1, mvi = i >> 8;
      s.PBP[i] = cnf::parent_term(s.sl[ps], s.sl[ps + 1], s.sl[ps + 2],
                                  s.rootmv[mvi].vA[rr], s.rootmv[mvi].svA[rr],
                                  a, p, u);
    }
    __syncwarp();
    const T* Tk = side == 0 ? s.T1 : s.T0;
    const T* PBk = s.PB + side * 256;
    // share of allele value mvi at (r, a, p, t, u); side 1 reads r' = 1-r
    auto share = [&](int mvi, int rr, int a, int p, int t, int u) {
      const int rs = side == 0 ? rr : 1 - rr;
      const int j = ((rs * 8 + a) * 8 + p) * 2 + u;
      const T us0 = s.rootmv[0].froot[rs][t] * s.PBP[j];
      const T us1 = s.rootmv[1].froot[rs][t] * s.PBP[256 + j];
      return cnf::safe_div(mvi == 0 ? us0 : us1, us0 + us1);
    };
    // X[r,a,p] = sum_{t,u} froot[r,t] * Tk[r,a,u,t] * PBk[r,a,p,u] * sh
    for (int i = lane; i < 256; i += 32) {
      const int p = i & 7, a = (i >> 3) & 7, rr = (i >> 6) & 1, mvi = i >> 7;
      T X = T(0);
      for (int t = 0; t < 2; ++t)
        for (int u = 0; u < 2; ++u) {
          const T ft = fr[rr][t] * Tk[((rr * 8 + a) * 2 + u) * 2 + t];
          X += ft * PBk[((rr * 8 + a) * 8 + p) * 2 + u] *
               share(mvi, rr, a, p, t, u);
        }
      // focal: side 0 row r -> w = r; side 1 row r -> w = 1 - r
      acc[0][side == 0 ? rr : 1 - rr][mvi] += X;
      acc[ps][p & 1][mvi] += X;
      for (int j = 0; j < 2; ++j)
        if ((a & 1) == j) acc[ps + 1 + j][(p >> (1 + j)) & 1][mvi] += X;
    }
    // branch collapsed with its share, for the pair table:
    // P[mvi][r][a][u][t] = sum_p PBk[r,a,p,u] * sh[r,a,p,t,u]
    T* P = side == 0 ? s.P0 : s.P1;
    for (int i = lane; i < 128; i += 32) {
      const int t = i & 1, u = (i >> 1) & 1, a = (i >> 2) & 7,
                rr = (i >> 5) & 1, mvi = i >> 6;
      T v = T(0);
      for (int p = 0; p < 8; ++p)
        v += PBk[((rr * 8 + a) * 8 + p) * 2 + u] * share(mvi, rr, a, p, t, u);
      P[i] = v;
    }
  }
  __syncwarp();

  // pair[i][j] = sum_{r,t} froot[r,t] sum_{a,u} P0[i][r,a,u,t] *
  //              (sum_{b,v} P1[j][r,b,v,t] * W[b,a,v,u,t])
  T pp[2][2] = {};
  for (int i = lane; i < 128; i += 32) {
    const int t = i & 1, u = (i >> 1) & 1, a = (i >> 2) & 7,
              rr = (i >> 5) & 1, j = i >> 6;
    T tv = T(0);
    for (int b = 0; b < 8; ++b)
      for (int v = 0; v < 2; ++v)
        tv += s.P1[(((j * 2 + rr) * 8 + b) * 2 + v) * 2 + t] *
              Wat(s, b, a, v, u, t);
    const int q = ((rr * 8 + a) * 2 + u) * 2 + t;
    pp[0][j] += fr[rr][t] * (s.P0[q] * tv);
    pp[1][j] += fr[rr][t] * (s.P0[64 + q] * tv);
  }
  T* ao = acc_out + ((size_t)r * M + m) * 28;
#pragma unroll
  for (int q = 0; q < 28; ++q) {
    const T v = warp_sum(acc[q / 4][(q / 2) & 1][q & 1]);
    if (lane == 0) ao[q] = v;
  }
  T* po = pair_out + ((size_t)r * M + m) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const T v = warp_sum(pp[q >> 1][q & 1]);
    if (lane == 0) po[q] = v;
  }
}

template <typename T, class L>
int launch_stats(const int* md, const T* ms, const T* hw, const int* ex,
                 const int* at, const int* f2, const int* sh, const T* fw_pre,
                 const T* bw, const T* fw_pre_f, const T* bw_f,
                 const T* total, T* b12, T* accum, T* pair, const L& lay,
                 void* stream) {
  if (lay.M <= 0 || lay.B <= 0) return 0;
  const size_t smem = sizeof(Scratch<T>) * kWarps;
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)lay.M * lay.B;
  const dim3 grid((unsigned)((pairs + kWarps - 1) / kWarps));
  stats_kernel<T, L><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      md, ms, hw, ex, at, f2, sh, fw_pre, bw, fw_pre_f, bw_f, total, b12,
      accum, pair, lay);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cnf_stats_f32(const int* md, const float* ms, const float* hw,
                  const int* ex, const int* at, const int* f2, const int* sh,
                  const float* fw_pre, const float* bw, const float* fw_pre_f,
                  const float* bw_f, const float* total, float* b12,
                  float* accum, float* pair, int M, int R, int B,
                  void* stream) {
  return launch_stats<float>(md, ms, hw, ex, at, f2, sh, fw_pre, bw, fw_pre_f,
                             bw_f, total, b12, accum, pair,
                             V2Layout{M, R, B}, stream);
}

int cnf_stats_f64(const int* md, const double* ms, const double* hw,
                  const int* ex, const int* at, const int* f2, const int* sh,
                  const double* fw_pre, const double* bw,
                  const double* fw_pre_f, const double* bw_f,
                  const double* total, double* b12, double* accum,
                  double* pair, int M, int R, int B, void* stream) {
  return launch_stats<double>(md, ms, hw, ex, at, f2, sh, fw_pre, bw,
                              fw_pre_f, bw_f, total, b12, accum, pair,
                              V2Layout{M, R, B}, stream);
}

int cnf_stats_bmns_f32(const int* md, const float* ms, const float* hw,
                       const int* ex, const int* at, const int* f2,
                       const int* sh, const float* fw_pre, const float* bw,
                       const float* fw_pre_f, const float* bw_f,
                       const float* total, float* b12, float* accum,
                       float* pair, int M, int B, void* stream) {
  return launch_stats<float>(md, ms, hw, ex, at, f2, sh, fw_pre, bw, fw_pre_f,
                             bw_f, total, b12, accum, pair,
                             BMNSLayout{M, B}, stream);
}

int cnf_stats_bmns_f64(const int* md, const double* ms, const double* hw,
                       const int* ex, const int* at, const int* f2,
                       const int* sh, const double* fw_pre, const double* bw,
                       const double* fw_pre_f, const double* bw_f,
                       const double* total, double* b12, double* accum,
                       double* pair, int M, int B, void* stream) {
  return launch_stats<double>(md, ms, hw, ex, at, f2, sh, fw_pre, bw,
                              fw_pre_f, bw_f, total, b12, accum, pair,
                              BMNSLayout{M, B}, stream);
}

}  // extern "C"
