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
//   cnf_fb_ext_carry_*  one direction carry-only (its own body, below):
//                       forward from the carry entering the block to
//                       the one entering the next; backward from bw at
//                       the block's last marker through markers
//                       K-1..0, the step at marker 0 taking lam_below
//                       and C_below [B, V, V], the interval below the
//                       block, in the same from -> to orientation.  It
//                       reads e and C once and stores only the outgoing
//                       carry.
//
// Bound on the H100 of the whole sweeps and the seeded entry: memory.  Per
// marker a warp reads V rows of e and writes two stored rows forward
// (fw_pre, fw_post) or one backward (bw): at B = 1000, M = 192, V = 3
// that is 4.7 GB in float32.  One warp owns a
// (unit, shift): lane l holds states l and l + 32 of each of the V rows
// (2V registers), the joint renormalising sum is one warp reduction of
// the lane's 2V values, the 64-point FWHT of each row runs as in
// csrc/fb_classic.cu (the stride-32 stage inside the thread, strides
// 16..1 by __shfl_xor_sync), and the [V, V] mix is per lane.  Forward and
// backward sweeps are independent and run as the two halves of one grid
// (gridDim.y == 2).  The next marker's e rows are loaded before the
// current step's arithmetic.  No fast math: the clip and log must stay
// exact.
//
// The carry-only entry is bound by memory too (at one K = 256 block of the
// selfing slice, V = 3, it reads 1.6 GB of e in float32: 0.476 ms at 3.35
// TB/s), if its step keeps within that: with one warp a chain, as above, a
// chain-step costs 65 warp-shuffles (five for the joint sum, 60 in the
// FWHTs), more issue than the bytes allow, and its 192 quotients each take
// their own range check and slow-path region.  Its body: kCarryLanes = 8
// lanes share a (unit, shift) chain, lane q holding 8 states of each V row
// in 16-byte vectors, state (j * 8 + q) * W + i in value i of vector j (W =
// 16 / sizeof(T)), so the chain's 8 lanes read 128 contiguous bytes a
// vector; the FWHT strides within a vector and between a lane's vectors run
// in registers and only the three lane strides go through __shfl_xor_sync
// (the plain twin's stride order is kept); the joint sum takes three
// shuffles.  The carry is scaled (y, c) (csrc/renorm.cuh): no division and
// no log on the chain, one log at the end.  The lam rows come through
// shared memory, a double-buffered tile of kLamTile rows a block staged by
// cp.async, and the next marker's e rows and [V, V] coupling are loaded
// into registers while the current step's transition runs.  Kept from
// variant runs at that block (NVIDIA H100 80GB HBM3, 700.00 W): 8 lanes in
// both types (4 lanes took 0.64-0.70 ms in float32: twice the registers for
// the carry and the e rows, so fewer warps in flight; 16 lanes 0.91 ms),
// 256 threads a block, tiles of 32 lam rows (16 the same).  The shuffles
// are (2 x 3 x 3 x 8 + 3) / 4 = 37 a chain-step in float32 at V = 3 (twice
// that in double), 0.3 ms of issue at this block: the bytes bind again.
// -Xptxas -v: 128 / 116 registers in float (V = 3 / 2), 242 / 178 in
// double, no spills; 16 / 32 KB of shared memory a block.
#include <cuda_runtime.h>

#include <initializer_list>

#include "blocks.cuh"
#include "pipeline.cuh"
#include "renorm.cuh"
#include "warp.cuh"

namespace {

constexpr int kWarps = 4;
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
  const T s = cnf::warp_sum(part);  // the same value in every lane
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
    cnf::fwht64(lo[v], hi[v], lane);
    lo[v] *= llo;
    hi[v] *= lhi;
    cnf::fwht64(lo[v], hi[v], lane);
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

// ---- the carry-only entry: L lanes a (unit, shift) chain -------------

constexpr int kCarryLanes = 8;  // lanes a (unit, shift) chain
constexpr int kCarryThreads = 256;
constexpr int kLamTile = 32;  // interval rows a staged tile

// the L lanes of this lane's chain (aligned groups of L lanes)
template <int L>
__device__ __forceinline__ unsigned chain_mask(int lane) {
  static_assert(L > 1 && L < 32 && (L & (L - 1)) == 0,
                "L: a power of two in [2, 16]");
  return ((1u << L) - 1u) << (lane & ~(L - 1));
}

// one 16-byte vector of W = 16 / sizeof(T) values
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ float get(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ float4 make(const float* x) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ double get(const double2& v, int i) {
    return i == 0 ? v.x : v.y;
  }
  static __device__ __forceinline__ double2 make(const double* x) {
    return make_double2(x[0], x[1]);
  }
};

// A chain's row of 64 states over its L lanes: lane q holds P = 64 / L
// states, register r = j * W + i (vector j < P / W, i < W) holding state
// (j * L + q) * W + i, so that each lane's vector j is 16 contiguous bytes
// and the chain's L lanes read 16 L contiguous bytes.
template <typename T, int L>
struct Chain {
  static constexpr int W = 16 / (int)sizeof(T);
  static constexpr int P = 64 / L;
  static constexpr int G = P / W;
};

// the lane's P states of one row whose state 0 is at `at` (the lane's
// own offset q * W already in `at`): vector g of the lane is 16 L bytes
// after vector g - 1
template <typename T, int L>
__device__ __forceinline__ void load_row(T (&x)[64 / L],
                                         const T* __restrict__ at) {
  using V = Vec16<T>;
  constexpr int W = Chain<T, L>::W, G = Chain<T, L>::G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const typename V::type v =
        *reinterpret_cast<const typename V::type*>(at + g * L * W);
#pragma unroll
    for (int i = 0; i < W; ++i) x[g * W + i] = V::get(v, i);
  }
}

template <typename T, int L>
__device__ __forceinline__ void store_row(T* __restrict__ at,
                                          const T (&x)[64 / L]) {
  using V = Vec16<T>;
  constexpr int W = Chain<T, L>::W, G = Chain<T, L>::G;
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<typename V::type*>(at + g * L * W) =
        V::make(&x[g * W]);
}

// one butterfly stage between the lane's registers r and r + h (the trip
// count is P whatever h is, so the loop unrolls fully once h is known)
template <typename T, int P>
__device__ __forceinline__ void butterflies(T (&x)[P], int h) {
#pragma unroll
  for (int r = 0; r < P; ++r)
    if ((r & h) == 0) {
      const T a = x[r], b = x[r + h];
      x[r] = a + b;
      x[r + h] = a - b;
    }
}

// unnormalised FWHT64 of one row over the chain, butterfly strides in the
// plain twin's order 1, 2, ..., 32: state strides below W in the lane's
// vectors, strides W .. W L / 2 across the lanes q ^ (h / W), strides
// from W L up between the lane's vectors
template <typename T, int L>
__device__ __forceinline__ void chain_fwht64(T (&x)[64 / L], int q,
                                             unsigned mask) {
  constexpr int W = Chain<T, L>::W, P = Chain<T, L>::P;
#pragma unroll
  for (int h = 1; h < W; h <<= 1) butterflies<T, P>(x, h);
#pragma unroll
  for (int b = 1; b < L; b <<= 1) {
    const bool upper = (q & b) != 0;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const T o = __shfl_xor_sync(mask, x[r], b);
      x[r] = upper ? o - x[r] : x[r] + o;
    }
  }
#pragma unroll
  for (int h = W; h < P; h <<= 1) butterflies<T, P>(x, h);
}

// The emission of a chain's scaled carry (csrc/renorm.cuh): values below
// thr (the clip times c) zeroed, times e, in place; returns the joint sum
// over the V rows, the lane's partial sum then log2 L xor-shuffles, so
// that every lane of the chain holds the same value.
template <typename T, int V, int L>
__device__ __forceinline__ T chain_emit(T (&x)[V][64 / L],
                                        const T (&e)[V][64 / L], T thr,
                                        unsigned mask) {
  constexpr int P = 64 / L;
  T s = T(0);
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int r = 0; r < P; ++r) {
      x[v][r] = (x[v][r] < thr ? T(0) : x[v][r]) * e[v][r];
      s += x[v][r];
    }
#pragma unroll
  for (int o = 1; o < L; o <<= 1) s += __shfl_xor_sync(mask, s, o);
  return s;
}

// the base-state transition of every row, H . diag(lam) . H scaled by
// `scale` (the 1/64 and the carry's power of two), then the [V, V]
// coupling mix out[g] = sum_f c[f][g] in[f]
template <typename T, int V, int L>
__device__ __forceinline__ void chain_transition(T (&x)[V][64 / L],
                                                 const T (&lam)[64 / L],
                                                 const T (&c)[V * V], T scale,
                                                 int q, unsigned mask) {
  constexpr int P = 64 / L;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    chain_fwht64<T, L>(x[v], q, mask);
#pragma unroll
    for (int r = 0; r < P; ++r) x[v][r] *= lam[r];
    chain_fwht64<T, L>(x[v], q, mask);
#pragma unroll
    for (int r = 0; r < P; ++r) x[v][r] *= scale;
  }
#pragma unroll
  for (int r = 0; r < P; ++r) {
    T out[V];
#pragma unroll
    for (int g = 0; g < V; ++g) {
      out[g] = T(0);
#pragma unroll
      for (int fr = 0; fr < V; ++fr) out[g] += c[fr * V + g] * x[fr][r];
    }
#pragma unroll
    for (int g = 0; g < V; ++g) x[g][r] = out[g];
  }
}

// Issue the copies of lam tile t (if there is one) as one commit group:
// slot row d holds the interval of step j = t * kLamTile + d (forward:
// lam row j; backward, at marker m = K - 1 - j: lam row m - 1, lam_below
// at marker 0).
template <typename T>
__device__ __forceinline__ void stage_lam(T (*lam_s)[kLamTile * 64], int t,
                                          int K, const T* __restrict__ lam,
                                          const T* __restrict__ lam_below,
                                          bool backward) {
  if (t * kLamTile < K) {
    constexpr int W = 16 / (int)sizeof(T);
    constexpr int rchunks = 64 / W;
    const int n = min(kLamTile, K - t * kLamTile);
    T* slot = lam_s[t & 1];
    for (int c = threadIdx.x; c < n * rchunks; c += kCarryThreads) {
      const int d = c / rchunks, w = c - d * rchunks;
      const int j = t * kLamTile + d, m = K - 1 - j;
      const T* src = !backward ? lam + (size_t)j * 64
                     : m > 0   ? lam + (size_t)(m - 1) * 64
                               : lam_below;
      cnf::copy16_async(slot + d * 64 + w * W, src + w * W);
    }
  }
  cnf::commit_group();
}

// the [V, V] coupling of the step at marker m (V * V values at
// cb + i * V * V for interval i): forward the interval leaving m,
// backward the one entering it, C_below's row at marker 0
template <typename T, int V>
__device__ __forceinline__ const T* interval_c(const T* cb, const T* c_below,
                                               int m, int backward) {
  if (!backward) return cb + (size_t)m * V * V;
  return m > 0 ? cb + (size_t)(m - 1) * V * V : c_below;
}

// one direction, carry-only: per (unit, shift) row, L lanes take the
// carry (p_in, f_in) through the block's K markers into (p_out, f_out)
template <typename T, int V, int L>
__global__ void __launch_bounds__(kCarryThreads)
    fb_ext_carry_kernel(const T* __restrict__ e, const T* __restrict__ lam,
                        const T* __restrict__ C,
                        const T* __restrict__ lam_below,
                        const T* __restrict__ C_below,
                        const T* __restrict__ p_in,
                        const T* __restrict__ f_in, T* __restrict__ p_out,
                        T* __restrict__ f_out, int backward, int B, int K,
                        int NS, T clip) {
  constexpr int W = Chain<T, L>::W, P = Chain<T, L>::P;
  // the interval rows, double-buffered tiles (the copies of tile t + 1
  // fly while tile t is swept)
  __shared__ __align__(16) T lam_s[2][kLamTile * 64];
  const int q = threadIdx.x & (L - 1);
  const long long row =
      (long long)blockIdx.x * (kCarryThreads / L) + threadIdx.x / L;
  const bool active = row < (long long)B * NS;  // uniform over the chain
  const unsigned mask = chain_mask<L>(threadIdx.x & 31);
  const int b = active ? (int)(row / NS) : 0;
  const int ns = active ? (int)(row % NS) : 0;
  // element (b, m, v, ns, s) of e is b * K * mstep + m * mstep +
  // v * vstep + ns * 64 + s; a carry [B, V, NS, 64] is one marker of it
  const size_t vstep = (size_t)NS * 64;
  const size_t mstep = (size_t)V * vstep;
  const size_t lane_off = (size_t)ns * 64 + q * W;
  const T* eb = e + (size_t)b * K * mstep + lane_off;
  const size_t carry = (size_t)b * mstep + lane_off;
  // the step's e rows and coupling: forward, marker j and the interval
  // leaving it; backward, marker K - 1 - j and the interval entering it
  // (C_below at marker 0), in the same from -> to orientation
  const int first = backward ? K - 1 : 0, dir = backward ? -1 : 1;
  const T* cb = C + (size_t)b * K * V * V;
  const T* c_below = backward ? C_below + (size_t)b * V * V : nullptr;

  // the chain's scaled carry (x, c) and its log-factor (csrc/renorm.cuh)
  T x[V][P], ev[V][P], cm[V * V], cn[V * V], lr[P];
  T c = T(1), f = T(0);
  if (active) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      load_row<T, L>(x[v], p_in + carry + v * vstep);
    f = f_in[row];
#pragma unroll
    for (int v = 0; v < V; ++v)
      load_row<T, L>(ev[v], eb + (size_t)first * mstep + v * vstep);
    const T* c0 = interval_c<T, V>(cb, c_below, first, backward);
#pragma unroll
    for (int k = 0; k < V * V; ++k) cm[k] = c0[k];
  }
  cnf::LogFactor<T> lf{f};
  stage_lam(lam_s, 0, K, lam, lam_below, backward);
  const int ntiles = (K + kLamTile - 1) / kLamTile;
  for (int t = 0; t < ntiles; ++t) {
    cnf::wait_groups<0>();
    __syncthreads();
    stage_lam(lam_s, t + 1, K, lam, lam_below, backward);
    if (!active) continue;
    const int j0 = t * kLamTile, n = min(kLamTile, K - j0);
    const T* ls = lam_s[t & 1] + q * W;
    for (int d = 0; d < n; ++d) {
      const int j = j0 + d;
      const T s = chain_emit<T, V, L>(x, ev, clip * c, mask);
      const int ex = cnf::Pow2<T>::exponent(s);
      // the next step's inputs fly while this step's transition runs
      if (j + 1 < K) {
        const int m = first + dir * (j + 1);
#pragma unroll
        for (int v = 0; v < V; ++v)
          load_row<T, L>(ev[v], eb + (size_t)m * mstep + v * vstep);
        const T* cnext = interval_c<T, V>(cb, c_below, m, backward);
#pragma unroll
        for (int k = 0; k < V * V; ++k) cn[k] = cnext[k];
      }
      load_row<T, L>(lr, ls + d * 64);
      chain_transition<T, V, L>(x, lr, cm, cnf::Pow2<T>::pow2(ex, 6), q,
                                mask);
      c = s * cnf::Pow2<T>::pow2(ex, 0);
      lf.count(s, ex);
#pragma unroll
      for (int k = 0; k < V * V; ++k) cm[k] = cn[k];
    }
  }
  if (active) {
    cnf::unscale(x, c);
#pragma unroll
    for (int v = 0; v < V; ++v)
      store_row<T, L>(p_out + carry + v * vstep, x[v]);
    if (q == 0) f_out[row] = lf.value();
  }
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
  if (backward && (lam_below == nullptr || C_below == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || K <= 0 || NS <= 0) return 0;
  // the 16-byte loads, copies and stores
  for (const T* p : {e, lam, lam_below, p_in, (const T*)p_out})
    if (((size_t)p & 15) != 0) return (int)cudaErrorMisalignedAddress;
  constexpr int L = kCarryLanes;
  constexpr int chains = kCarryThreads / L;
  const long long rows = (long long)B * NS;
  const unsigned grid = (unsigned)((rows + chains - 1) / chains);
  cudaStream_t s = (cudaStream_t)stream;
  if (V == 2) {
    fb_ext_carry_kernel<T, 2, L><<<grid, kCarryThreads, 0, s>>>(
        e, lam, C, lam_below, C_below, p_in, f_in, p_out, f_out, backward, B,
        K, NS, clip);
  } else if (V == 3) {
    fb_ext_carry_kernel<T, 3, L><<<grid, kCarryThreads, 0, s>>>(
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
