// Posterior update statistics per (marker, unit) pair.
//
// Replaces the TPU kernel cnf2freq_tpu/ops/stats_pallas.py::_kernel (body
// stats_tile), launched on the main path by ops/scan_v2.py::stats_from_v2,
// in both of its forms (rules=False, and rules=True for parity mode's
// probe dedup, below).  Per pair (m, r):
//   W[b,a,v,u,t] = fw_pre * bw * exp(fw_pre_f + bw_f - total) * allowed,
//   the root and masked parent blocks PBm[k][r0][fp][fpath][sk],
//   the side collapses T1 (branch 1 folded) and T0 (branch 0 folded),
//   haplo b12 [7][2], infprob accum [7][2][2] (GENOSPROBE shares of the
//   focal's allele values 1 and 2 on either root side) and pair [2][2].
// Outputs are written straight in the [B, M, ...] layout.
//
// The probe-rule form (a compile-time flag, entries cnf_stats_rules_* and
// cnf_stats_bmns_rules_*) also reads the empty-slot flags em and one
// dup-flip variant df per unit, and multiplies froot by
//   F0[r0][s0] = (tied(0) ? r0 ^ s0 : 1) * (dupf(0) ? 1 - 2 r0 : 1)
// and each masked parent-block entry of side k by the product over its
// path bits (xp = (f ^ fpath) & 1 for the parent ps, xg_j the bit 1 + j
// of f ^ fpath for grandparent gs_j) of
//   (tied(ps) ? xp ^ sk : 1) (dupf(ps) ? 1 - 2 xp : 1)
//   (tied(gs_j) ? xg_j : 1) (dupf(gs_j) ? 1 - 2 xg_j : 1),
// tied(s) = exists & !em & md[s,0] == md[s,1] & ms[s,0] == ms[s,1]
// (ignoreflag2 rules 2-3; stats_pallas.py::_rule_factors_tile).  Each
// factor is 0 or +-1, so the decoration is exact.  As in the TPU body the
// allele-value shares stay undecorated: the reciprocal of U0 + U1 below
// only ever sees undecorated, non-negative entries.  The caller launches
// once per variant and averages.
//
// Two layouts share the kernel body, which reads its inputs through a
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
//                     consecutive markers of one unit.
//
// What the TPU body does: it enumerates every parent-block entry
// (r0, fp, fpath, sk) as one vector lane, 512 for the masked blocks and
// 2 x 512 for the allele-value blocks, and evaluates the full
// parent_block_L expression (one parent match, two grandparent matches,
// three phase factors) in each; the allele-value shares are divided out
// once per use.  That fills the TPU's vector unit.  On a GPU it is
// scalar work repeated: an entry is a product of a few small factors,
//   weight(fpath) * A(branch, rp) * ph(rp ^ p0 ^ sk)
//     * GF(branch, rp, gp_{p0}, rg) * gph(rg ^ gb)
//     * GS(rp, gp_{1-p0}, rg') * gph(rg' ^ gb'),
// where A carries the parent's match and sec_f, GF the first
// grandparent's match of the branch's bound value, GS the second
// grandparent's match of the parent's other allele (the same for every
// branch) and ph / gph the phase factors; the vacant and attop cases pick
// which factors apply per slot, uniformly over the warp.
//
// Bound on the H100: bytes, the 2 x 512 sweep values read per pair
// (0.26 ms at M=192, B=1000 in f32); the arithmetic left is ~20k flops
// per pair.  Design: one warp per pair, 8 warps per block, the register
// cap set for 4 blocks per SM in f32 and 3 in f64.
//   1. The block loads its pairs' sweeps together, adjacent threads on
//      adjacent addresses in either layout, into W in shared memory.
//   2. Separable tables: 12 branches (root, per side 2 root values and 4
//      allele-value roots) x rp -> A, GF; GS, ph, gph per side.  ~140
//      match evaluations per pair instead of ~4,600.
//   3. Lane (r0, f, sk) forms its 8 masked entries (one per fpath) of each
//      side in registers from the tables; the haplo moments and the side
//      collapses read them there.  The allele-value entries are formed
//      where they are used: lane (r0, a, u) visits each share entry
//      (rs, a, p, u, t) of its side once, takes one reciprocal of
//      U0 + U1 (0 where the sum is not positive) and uses sh0 = U0 * inv,
//      sh1 = U1 * inv for both the infprob sums and the pair collapse.
//   4. Each lane keeps partials of the 46 outputs; one shuffle
//      reduce-scatter per output group (b12, each side's accum, pair)
//      leaves one output per lane or lane pair: 53 shuffles in place of
//      46 x 5, and only one group's partials live at a time.
// Shared memory per warp holds W, the side collapses, the pair collapse
// of side 1 (832 values), the tables, slots and roots: 4.4 KB in f32,
// 8.6 KB in f64.
#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// index arithmetic of the v2 layout (R = padded batch, B real units)
struct V2Layout {
  static constexpr bool kUnitsAdjacent = true;  // sweep(m, r + 1) = +1
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
  static constexpr bool kUnitsAdjacent = false;  // x is contiguous
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

// Branches: beta = k * 6 + b for parent side k; b = 0, 1 the masked
// block's root value for r0 = b (vA for k = 0, vB for k = 1); b = 2..5 the
// allele-value root mvi = (b - 2) >> 1 of side k at r0 = (b - 2) & 1.
constexpr int kBranches = 12;

template <typename T>
struct Scratch {
  T W[512];      // x order: ((v*2+u)*2+t)*64 + b*8 + a
  T PBq[64];     // path-summed masked blocks [k][r][f][s]
  T T1[64];      // [r][a][u][t]
  T T0[64];      // [r][b][v][t]
  T P1[128];     // side-1 pair collapse [mvi][r][b][v][t]
  T A[kBranches][2];            // [beta][rp]
  T GF[kBranches][2][2][2];     // [beta][rp][j][rg], first grandparent
  T GS[2][2][2][2];             // [k][j][rp][rg], second grandparent
  T PH[2][2];                   // [k][x] parent phase
  T GPH[2][2][2];               // [k][j][x] grandparent phase (1 if vacant)
  T wexp[8];
  cnf::Slot<T> sl[7];
  cnf::Root<T> root;
  cnf::Root<T> rootmv[2][2];    // [side][mvi]: focal value mvi + 1
  size_t base;                  // sweep offset of the warp's pair
  int valid;
};

// branch value (v, sv) of beta
template <typename T>
__device__ __forceinline__ void branch_value(const Scratch<T>& s, int beta,
                                             int& v, T& sv) {
  const int k = beta / 6, b = beta % 6;
  if (b < 2) {
    v = k == 0 ? s.root.vA[b] : s.root.vB[b];
    sv = k == 0 ? s.root.svA[b] : s.root.svB[b];
  } else {
    const cnf::Root<T>& rm = s.rootmv[k][(b - 2) >> 1];
    v = rm.vA[(b - 2) & 1];
    sv = rm.svA[(b - 2) & 1];
  }
}

// The per-pair tables (all lanes of the warp; caller syncs after).
// Lanes 0-23: (beta, rp) -> A and the four GF.  Lanes 24-31: GS (two rg
// each) and the phase factors.
template <typename T>
__device__ __forceinline__ void build_tables(Scratch<T>& s, int lane) {
  if (lane < 2 * kBranches) {
    const int beta = lane >> 1, rp = lane & 1, k = beta / 6;
    const cnf::Slot<T>& par = s.sl[1 + 3 * k];
    int v;
    T sv;
    branch_value(s, beta, v, sv);
    T a = T(1) + sv;
    T gf[2][2] = {};
    if (par.exists) {
      T bv_raw, pre;
      int bound;
      cnf::match_raw(v, sv, par.md[rp], par.ms[rp], bv_raw, pre, bound);
      if (par.attop) {
        a = bv_raw + pre;
      } else {
        const T ms_o = par.ms[1 - rp];
        a = bv_raw * (ms_o != T(0) ? T(1) - ms_o : T(1));
        const T ms_nab = cnf::safe_div(pre, bv_raw);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const cnf::Slot<T>& gp = s.sl[2 + 3 * k + j];
#pragma unroll
          for (int rg = 0; rg < 2; ++rg)
            gf[j][rg] = gp.exists
                            ? cnf::matched(bound, ms_nab, gp.md[rg], gp.ms[rg])
                            : T(1) + ms_nab;
        }
      }
    }
    s.A[beta][rp] = a;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int rg = 0; rg < 2; ++rg) s.GF[beta][rp][j][rg] = gf[j][rg];
  } else {
    const int i = lane - 2 * kBranches;  // 0..7
    const int k = i >> 2, j = (i >> 1) & 1, rp = i & 1;
    const cnf::Slot<T>& par = s.sl[1 + 3 * k];
    const cnf::Slot<T>& gp = s.sl[2 + 3 * k + j];
    const int md_o = par.md[1 - rp];
    const T ms_o = par.ms[1 - rp];
    const T secsec = ms_o != T(0) ? cnf::safe_div(ms_o, T(1) - ms_o) : T(0);
#pragma unroll
    for (int rg = 0; rg < 2; ++rg)
      s.GS[k][j][rp][rg] =
          gp.exists ? cnf::matched(md_o, secsec, gp.md[rg], gp.ms[rg])
                    : T(1) + secsec;
    // grandparent phase [k][j][x = rp]; parent phase [k'][x] on i < 4
    s.GPH[k][j][rp] = gp.exists ? cnf::phase(gp, rp) : T(1);
    if (i < 4) s.PH[i >> 1][i & 1] = cnf::phase(s.sl[1 + 3 * (i >> 1)], i & 1);
  }
}

// canonical-path weights of side k as a bit mask over fpath
template <typename T>
__device__ __forceinline__ int path_mask(const Scratch<T>& s, int k) {
  const cnf::Slot<T>& par = s.sl[1 + 3 * k];
  const bool deep_ok = par.exists && !par.attop;
  const bool g0 = deep_ok && s.sl[2 + 3 * k].exists;
  const bool g1 = deep_ok && s.sl[3 + 3 * k].exists;
  int mask = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const bool w = (par.exists || (p & 1) == 0) &&
                   (g0 || ((p >> 1) & 1) == 0) && (g1 || (p >> 2) == 0);
    mask |= w ? 1 << p : 0;
  }
  return mask;
}

// one parent-block entry of side k, branch beta, (fp, fpath, sk) from the
// tables: parent_block_L of ops/stats.py, factor by factor
template <typename T>
__device__ __forceinline__ T entry(const Scratch<T>& s, int k, int beta,
                                   int mask, bool exists, bool attop, int fp,
                                   int fpath, int sk) {
  if (!((mask >> fpath) & 1)) return T(0);
  const int rp = fpath & 1, rg0 = (fpath >> 1) & 1, rg1 = fpath >> 2;
  const T a = s.A[beta][rp];
  if (!exists) return a;
  const int p0 = fp & 1, gb0 = (fp >> 1) & 1, gb1 = fp >> 2;
  const T ph = s.PH[k][rp ^ p0 ^ sk];
  if (attop) return a * ph;
  const T g0 = s.GPH[k][0][rg0 ^ gb0], g1 = s.GPH[k][1][rg1 ^ gb1];
  const T g = p0 == 0 ? s.GF[beta][rp][0][rg0] * g0 *
                            (s.GS[k][1][rp][rg1] * g1)
                      : s.GF[beta][rp][1][rg1] * g1 *
                            (s.GS[k][0][rp][rg0] * g0);
  return a * ph * g;
}

// Warp reduce-scatter of N partials (N a power of two, 2..32): each step
// halves the values a lane carries, exchanging the half its partner
// keeps.  Returns the warp sum of v[lane / (32 / N)].
template <int H, typename T, int N>
__device__ __forceinline__ void rs_step(T (&v)[N], int lane) {
  if constexpr (H >= 1) {
    constexpr int o = 32 * H / N;
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const T send = up ? v[i] : v[i + H];
      const T keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
    rs_step<H / 2>(v, lane);
  }
}

template <typename T, int N>
__device__ __forceinline__ T reduce_scatter(T (&v)[N], int lane) {
  rs_step<N / 2>(v, lane);
  T x = v[0];
#pragma unroll
  for (int o = 16 / N; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The register cap allows 4 blocks per SM in f32 (64 registers, 32
// warps) and 3 in f64 (80 registers, 24 warps).  Uncapped the kernel takes
// 75 and 114 registers, 3 and 2 blocks; capped it spills 8 and ~300 bytes
// and still runs 12-14% faster at 1000 x 192 (H100).
// The probe-rule factor (0 or +-1) of a masked parent-block entry of side
// k at lane (f, sk) and path p, from the warp's tied and dup-flip slot
// bit masks.
__device__ __forceinline__ int rule_factor(unsigned tied, unsigned dup,
                                           int k, int f, int p, int sk) {
  const int x = f ^ p, ps = 1 + 3 * k;
  const int xb[3] = {x & 1, (x >> 1) & 1, (x >> 2) & 1};
  if (((tied >> ps) & 1) && xb[0] == sk) return 0;
  int neg = (dup >> ps) & xb[0];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int gs = ps + 1 + j;
    if (((tied >> gs) & 1) && xb[1 + j] == 0) return 0;
    neg ^= (dup >> gs) & xb[1 + j];
  }
  return neg & 1 ? -1 : 1;
}

template <typename T, class L, bool Rules>
__global__ void __launch_bounds__(kWarps * 32, sizeof(T) == 4 ? 4 : 3)
    stats_kernel(const int* __restrict__ md, const T* __restrict__ ms,
                 const T* __restrict__ hw, const int* __restrict__ ex,
                 const int* __restrict__ at, const int* __restrict__ em,
                 const int* __restrict__ df, const int* __restrict__ f2,
                 const int* __restrict__ sh, const T* __restrict__ fw_pre,
                 const T* __restrict__ bw, const T* __restrict__ fw_pre_f,
                 const T* __restrict__ bw_f, const T* __restrict__ total,
                 T* __restrict__ b12_out, T* __restrict__ acc_out,
                 T* __restrict__ pair_out, const L lay) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Scratch<T>* all = reinterpret_cast<Scratch<T>*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Scratch<T>& s = all[warp];
  const long long pair = (long long)blockIdx.x * kWarps + warp;
  const int M = lay.M;
  const bool valid = pair < (long long)M * lay.B;
  int m = 0, r = 0;
  if (valid) lay.pair(pair, m, r);

  // ---- inputs --------------------------------------------------------
  if (valid) {
    if (lane < 7) s.sl[lane] = load_slot(md, ms, hw, ex, at, lane, m, r, lay);
    if (lane < 8) {
      const size_t fi = lay.fac(m, lane, r);
      const T allowed = (lane & sh[r]) == 0 ? T(1) : T(0);
      s.wexp[lane] = exp(fw_pre_f[fi] + bw_f[fi] - total[r]) * allowed;
    }
  }
  if (lane == 0) {
    s.base = valid ? lay.sweep(m, r) : 0;
    s.valid = valid;
  }
  __syncthreads();
  // the block's sweeps, adjacent threads on adjacent addresses
  const size_t stride = lay.xstride();
  for (int i = threadIdx.x; i < kWarps * 512; i += kWarps * 32) {
    const int w = L::kUnitsAdjacent ? i % kWarps : i >> 9;
    const int x = L::kUnitsAdjacent ? i / kWarps : i & 511;
    Scratch<T>& sw = all[w];
    if (sw.valid) {
      const size_t g = sw.base + x * stride;
      sw.W[x] = fw_pre[g] * bw[g] * sw.wexp[x >> 6];
    }
  }
  if (valid && lane < 5) {
    if (lane == 0)
      cnf::root_block(s.sl[0], 0, 0, s.root);
    else
      cnf::root_block(s.sl[0], ((lane - 1) & 1) + 1, (lane - 1) >> 1,
                      s.rootmv[(lane - 1) >> 1][(lane - 1) & 1]);
  }
  __syncthreads();
  if (!valid) return;
  build_tables(s, lane);
  __syncwarp();

  // lane = (r0, f, sk) of the masked blocks = (r0, a, u) of the side
  // loops below
  const int rr = lane >> 4, f = (lane >> 1) & 7, sk = lane & 1;
  const int f2ig = f2[r];
  T fr[2] = {s.root.froot[rr][0], s.root.froot[rr][1]};
  // the probe-rule slot masks: bit s of tied / dup for slot s
  unsigned tied = 0, dup = 0;
  if constexpr (Rules) {
    bool t = false, d = false;
    if (lane < 7) {
      const cnf::Slot<T>& sl = s.sl[lane];
      const size_t i = lay.ex(lane, r);
      t = sl.exists && em[i] == 0 && sl.md[0] == sl.md[1] &&
          sl.ms[0] == sl.ms[1];
      d = df[i] != 0;
    }
    tied = __ballot_sync(kFull, t);
    dup = __ballot_sync(kFull, d);
#pragma unroll
    for (int t0 = 0; t0 < 2; ++t0) {
      const int f0 = (tied & 1) ? (rr ^ t0) : 1;
      fr[t0] *= T((dup & 1) ? f0 * (1 - 2 * rr) : f0);
    }
  }
  bool pex[2], pat[2];
  int mask[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    pex[k] = s.sl[1 + 3 * k].exists;
    pat[k] = s.sl[1 + 3 * k].attop;
    mask[k] = path_mask(s, k);
  }

  // ---- masked parent blocks, in registers ---------------------------
  T pb[2][8];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int bits = (f2ig >> (1 + 3 * k)) & 7;
    // drop the fpaths p with bits & p != 0
    const int mk = mask[k] & ~((bits & 1 ? 0xaa : 0) | (bits & 2 ? 0xcc : 0) |
                               (bits & 4 ? 0xf0 : 0));
    T q = T(0);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      pb[k][p] = entry(s, k, k * 6 + rr, mk, pex[k], pat[k], f, p, sk);
      if constexpr (Rules) pb[k][p] *= T(rule_factor(tied, dup, k, f, p, sk));
      q += pb[k][p];
    }
    s.PBq[k * 32 + lane] = q;
  }
  __syncwarp();

  // ---- side collapses -----------------------------------------------
  for (int i = lane; i < 128; i += 32) {
    const int t = i & 1, u = (i >> 1) & 1, a = (i >> 2) & 7,
              r2 = (i >> 5) & 1;
    T acc = T(0);
    if (i < 64) {
      // T1[r,a,u,t] = sum_{b,v} PBq[1][r][b][v] * W[b,a,v,u,t]
      for (int b = 0; b < 8; ++b)
        for (int v = 0; v < 2; ++v)
          acc += s.PBq[((2 + r2) * 8 + b) * 2 + v] *
                 s.W[((v * 2 + u) * 2 + t) * 64 + b * 8 + a];
      s.T1[i] = acc;
    } else {
      // T0[r,b,v,t] = sum_{a,u} PBq[0][r][a][u] * W[b,a,v,u,t]
      const int bb = a, vv = u;
      for (int aa = 0; aa < 8; ++aa)
        for (int uu = 0; uu < 2; ++uu)
          acc += s.PBq[(r2 * 8 + aa) * 2 + uu] *
                 s.W[((vv * 2 + uu) * 2 + t) * 64 + bb * 8 + aa];
      s.T0[i - 64] = acc;
    }
  }
  __syncwarp();

  // ---- haplo stats --------------------------------------------------
  // hb[0..1] focal F bins (r ^ t); hb[2 + (k*3 + q)*2 + j] the moments of
  // parent k (q = 0) and its grandparents (q = 1, 2) on the phase bits
  // rp^p0^sk, rg0^gb0, rg1^gb1
  T hb[16] = {};
  {
    const T q0 = s.PBq[lane];
    const T x0 = fr[0] * (q0 * s.T1[lane * 2]);
    const T x1 = fr[1] * (q0 * s.T1[lane * 2 + 1]);
    hb[0] = rr == 0 ? x0 : x1;
    hb[1] = rr == 0 ? x1 : x0;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T* Tk = k == 0 ? s.T1 : s.T0;
    const T ftk = fr[0] * Tk[lane * 2] + fr[1] * Tk[lane * 2 + 1];
    T e[3][2] = {};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      e[0][p & 1] += pb[k][p];
      e[1][(p >> 1) & 1] += pb[k][p];
      e[2][p >> 2] += pb[k][p];
    }
    const bool c[3] = {((f & 1) ^ sk) != 0, ((f >> 1) & 1) != 0, f >= 4};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      hb[2 + (k * 3 + q) * 2 + 0] = ftk * (c[q] ? e[q][1] : e[q][0]);
      hb[2 + (k * 3 + q) * 2 + 1] = ftk * (c[q] ? e[q][0] : e[q][1]);
    }
  }
  {
    const T v = reduce_scatter(hb, lane);
    if ((lane & 1) == 0 && lane < 28)
      b12_out[((size_t)r * M + m) * 14 + (lane >> 1)] = v;
  }

  // ---- infprob stats and pair shares --------------------------------
  // Per side, v[w*2 + mvi] is the focal's share (slot 0) and
  // v[4 + (j*2 + w)*2 + mvi] that of slot ps + j (j = 0 the parent, 1, 2
  // its parents); each side is reduced on its own, so that lane l holds
  // index l >> 1 of it.
  T* ao = acc_out + ((size_t)r * M + m) * 28;
  T focal = T(0);  // side 0's focal share at this lane's index
  T p0r[2][2];     // side-0 pair collapse [mvi][t] of this lane
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int rs = side == 0 ? rr : 1 - rr;
    const T* Tk = side == 0 ? s.T1 : s.T0;
    const T ft[2] = {fr[0] * Tk[lane * 2], fr[1] * Tk[lane * 2 + 1]};
    const T fm[2][2] = {{s.rootmv[side][0].froot[rs][0],
                         s.rootmv[side][0].froot[rs][1]},
                        {s.rootmv[side][1].froot[rs][0],
                         s.rootmv[side][1].froot[rs][1]}};
    const int b0 = side * 6 + 2 + rs, b1 = side * 6 + 4 + rs;
    // X[mvi][r0, a, p] summed over p, by the parent bit rp and by the
    // grandparent bits rg0, rg1
    T all_p[2] = {}, par[2][2] = {}, g[2][2][2] = {};
    T P[2][2] = {};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const T pbp0 = entry(s, side, b0, mask[side], pex[side], pat[side], f,
                           p, sk);
      const T pbp1 = entry(s, side, b1, mask[side], pex[side], pat[side], f,
                           p, sk);
      T x[2] = {};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const T u0 = fm[0][t] * pbp0, u1 = fm[1][t] * pbp1;
        const T den = u0 + u1;
        const T inv = den > T(0) ? T(1) / den : T(0);
        const T q0 = pb[side][p] * (u0 * inv);
        const T q1 = pb[side][p] * (u1 * inv);
        P[0][t] += q0;
        P[1][t] += q1;
        x[0] += ft[t] * q0;
        x[1] += ft[t] * q1;
      }
#pragma unroll
      for (int mvi = 0; mvi < 2; ++mvi) {
        all_p[mvi] += x[mvi];
        par[p & 1][mvi] += x[mvi];
        g[0][(p >> 1) & 1][mvi] += x[mvi];
        g[1][p >> 2][mvi] += x[mvi];
      }
    }
    // focal: w = rs; parent: w = rp; grandparent j = a & 1: w = rg_j
    T v[16];
#pragma unroll
    for (int mvi = 0; mvi < 2; ++mvi) {
      v[0 + mvi] = rs == 0 ? all_p[mvi] : T(0);
      v[2 + mvi] = rs == 0 ? T(0) : all_p[mvi];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        v[4 + w * 2 + mvi] = par[w][mvi];
        v[8 + w * 2 + mvi] = (f & 1) == 0 ? g[0][w][mvi] : T(0);
        v[12 + w * 2 + mvi] = (f & 1) == 0 ? T(0) : g[1][w][mvi];
      }
    }
    const T red = reduce_scatter(v, lane);
    const int idx = lane >> 1;
    if (side == 0) {
      focal = red;
      if ((lane & 1) == 0 && idx >= 4) ao[idx] = red;
#pragma unroll
      for (int mvi = 0; mvi < 2; ++mvi)
#pragma unroll
        for (int t = 0; t < 2; ++t) p0r[mvi][t] = P[mvi][t];
    } else {
      if ((lane & 1) == 0) ao[idx < 4 ? idx : idx + 12] =
          idx < 4 ? focal + red : red;
#pragma unroll
      for (int mvi = 0; mvi < 2; ++mvi)
#pragma unroll
        for (int t = 0; t < 2; ++t)
          s.P1[(mvi * 32 + lane) * 2 + t] = P[mvi][t];
    }
  }
  __syncwarp();

  // pair[i][j] = sum_{r,t} froot[r,t] sum_{a,u} P0[i][r,a,u,t] *
  //              (sum_{b,v} P1[j][r,b,v,t] * W[b,a,v,u,t])
  T pv[4] = {};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      T tv = T(0);
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          tv += s.P1[(((j * 2 + rr) * 8 + b) * 2 + v) * 2 + t] *
                s.W[((v * 2 + sk) * 2 + t) * 64 + b * 8 + f];
      pv[0 * 2 + j] += fr[t] * (p0r[0][t] * tv);
      pv[1 * 2 + j] += fr[t] * (p0r[1][t] * tv);
    }
  const T red = reduce_scatter(pv, lane);
  if ((lane & 7) == 0) pair_out[((size_t)r * M + m) * 4 + (lane >> 3)] = red;
}

// em / df are null for the form without probe rules
template <typename T, class L, bool Rules = false>
int launch_stats(const int* md, const T* ms, const T* hw, const int* ex,
                 const int* at, const int* em, const int* df, const int* f2,
                 const int* sh, const T* fw_pre, const T* bw,
                 const T* fw_pre_f, const T* bw_f, const T* total, T* b12,
                 T* accum, T* pair, const L& lay, void* stream) {
  if (lay.M <= 0 || lay.B <= 0) return 0;
  if (Rules && (em == nullptr || df == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Scratch<T>) * kWarps;
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel<T, L, Rules>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)lay.M * lay.B;
  const dim3 grid((unsigned)((pairs + kWarps - 1) / kWarps));
  stats_kernel<T, L, Rules><<<grid, kWarps * 32, smem,
                              (cudaStream_t)stream>>>(
      md, ms, hw, ex, at, em, df, f2, sh, fw_pre, bw, fw_pre_f, bw_f, total,
      b12, accum, pair, lay);
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
  return launch_stats<float>(md, ms, hw, ex, at, nullptr, nullptr, f2, sh,
                             fw_pre, bw, fw_pre_f, bw_f, total, b12, accum,
                             pair, V2Layout{M, R, B}, stream);
}

int cnf_stats_f64(const int* md, const double* ms, const double* hw,
                  const int* ex, const int* at, const int* f2, const int* sh,
                  const double* fw_pre, const double* bw,
                  const double* fw_pre_f, const double* bw_f,
                  const double* total, double* b12, double* accum,
                  double* pair, int M, int R, int B, void* stream) {
  return launch_stats<double>(md, ms, hw, ex, at, nullptr, nullptr, f2, sh,
                              fw_pre, bw, fw_pre_f, bw_f, total, b12, accum,
                              pair, V2Layout{M, R, B}, stream);
}

int cnf_stats_bmns_f32(const int* md, const float* ms, const float* hw,
                       const int* ex, const int* at, const int* f2,
                       const int* sh, const float* fw_pre, const float* bw,
                       const float* fw_pre_f, const float* bw_f,
                       const float* total, float* b12, float* accum,
                       float* pair, int M, int B, void* stream) {
  return launch_stats<float>(md, ms, hw, ex, at, nullptr, nullptr, f2, sh,
                             fw_pre, bw, fw_pre_f, bw_f, total, b12, accum,
                             pair, BMNSLayout{M, B}, stream);
}

int cnf_stats_bmns_f64(const int* md, const double* ms, const double* hw,
                       const int* ex, const int* at, const int* f2,
                       const int* sh, const double* fw_pre, const double* bw,
                       const double* fw_pre_f, const double* bw_f,
                       const double* total, double* b12, double* accum,
                       double* pair, int M, int B, void* stream) {
  return launch_stats<double>(md, ms, hw, ex, at, nullptr, nullptr, f2, sh,
                              fw_pre, bw, fw_pre_f, bw_f, total, b12, accum,
                              pair, BMNSLayout{M, B}, stream);
}

// the probe-rule form: em [7, R] / [B, 7] int32 empty-slot flags, df one
// dup-flip variant in the same layout
int cnf_stats_rules_f32(const int* md, const float* ms, const float* hw,
                        const int* ex, const int* at, const int* em,
                        const int* df, const int* f2, const int* sh,
                        const float* fw_pre, const float* bw,
                        const float* fw_pre_f, const float* bw_f,
                        const float* total, float* b12, float* accum,
                        float* pair, int M, int R, int B, void* stream) {
  return launch_stats<float, V2Layout, true>(
      md, ms, hw, ex, at, em, df, f2, sh, fw_pre, bw, fw_pre_f, bw_f, total,
      b12, accum, pair, V2Layout{M, R, B}, stream);
}

int cnf_stats_rules_f64(const int* md, const double* ms, const double* hw,
                        const int* ex, const int* at, const int* em,
                        const int* df, const int* f2, const int* sh,
                        const double* fw_pre, const double* bw,
                        const double* fw_pre_f, const double* bw_f,
                        const double* total, double* b12, double* accum,
                        double* pair, int M, int R, int B, void* stream) {
  return launch_stats<double, V2Layout, true>(
      md, ms, hw, ex, at, em, df, f2, sh, fw_pre, bw, fw_pre_f, bw_f, total,
      b12, accum, pair, V2Layout{M, R, B}, stream);
}

int cnf_stats_bmns_rules_f32(const int* md, const float* ms, const float* hw,
                             const int* ex, const int* at, const int* em,
                             const int* df, const int* f2, const int* sh,
                             const float* fw_pre, const float* bw,
                             const float* fw_pre_f, const float* bw_f,
                             const float* total, float* b12, float* accum,
                             float* pair, int M, int B, void* stream) {
  return launch_stats<float, BMNSLayout, true>(
      md, ms, hw, ex, at, em, df, f2, sh, fw_pre, bw, fw_pre_f, bw_f, total,
      b12, accum, pair, BMNSLayout{M, B}, stream);
}

int cnf_stats_bmns_rules_f64(const int* md, const double* ms,
                             const double* hw, const int* ex, const int* at,
                             const int* em, const int* df, const int* f2,
                             const int* sh, const double* fw_pre,
                             const double* bw, const double* fw_pre_f,
                             const double* bw_f, const double* total,
                             double* b12, double* accum, double* pair, int M,
                             int B, void* stream) {
  return launch_stats<double, BMNSLayout, true>(
      md, ms, hw, ex, at, em, df, f2, sh, fw_pre, bw, fw_pre_f, bw_f, total,
      b12, accum, pair, BMNSLayout{M, B}, stream);
}

}  // extern "C"
