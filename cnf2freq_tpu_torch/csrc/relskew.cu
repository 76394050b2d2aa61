// The relative-skew smoothing HMM's ratio: per individual row of one
// chromosome, the posterior of phase state 1 at every marker, from a
// 2-state forward pass (emission at m, then transition relhaplo[m]) and an
// emission-inclusive backward pass.
//
// A kernel for an XLA program of the JAX package, not for a Pallas
// kernel: cnf2freq_tpu/updates/relskew.py::relskew_ratio, whose two
// lax.scans (forward at :50, backward at :66) the TPU ran inside the
// jitted update.  The port's plain twin, updates/relskew.py::
// relskew_ratio_reference, is a Python loop over the markers of about 10
// launches a marker and direction.
//   cnf_relskew_ratio_*   hw, rh [N, Mc] read in place through a row
//                         stride (the columns lo:hi of the cohort's
//                         [N, M] tensors); ratio [N, Mc]; scratch
//                         [Mc - 1, N, 2] for the stored states where
//                         they do not fit on chip (cnf_relskew_scratch
//                         says whether), else null.
// The renormalisation is the twin's: a state pair is multiplied by 1e20
// only when its mass is below 1e-10, else left as it is.  The arithmetic
// is the twin's, in the twin's order, rounded after every operation
// (rounded.cuh), so the ratio is the twin's bit for bit.
//
// Bound on the H100: bytes in principle, hw and rh read once and the
// ratio written once (2.3 MB in float32 at the slice's update, 3,040 rows
// x 192 markers: 2.1 us at 3.35 TB/s), but a row is a chain of dependent
// steps (a product, the mass, its test and the transition: ~7 rounded
// operations in series) and the ratio needs the backward chain too.
// 3,040 rows make 95 blocks of 32 rows, on 95 of the 132 SMs, so the time
// is one block's.  The design shortens the chain and keeps loads off it:
//  - forward and backward run at once, in the two warps of a block, lane
//    l of each holding row l of the block's 32: the chain is Mc steps, not
//    2 Mc.  Meet in the middle: each pass stores its states up to the
//    middle marker (phase 1), a block barrier, then each pass takes the
//    other's stored state at every marker past the middle and forms the
//    ratio there (phase 2);
//  - the stored states stay in shared memory ([Mc - 1][32] per state,
//    read by the other warp) where they fit beside the tiles (Mc up to
//    828 in float, 374 in double), else go to the scratch in device
//    memory and come back staged with the tiles in phase 2;
//  - hw and rh come through shared memory: each warp stages its rows'
//    values for kTile steps a tile, in its own direction, into a ring of
//    kStages tiles (cp.async, csrc/pipeline.cuh), kStages - 1 tiles
//    ahead; a tile's values enter registers before its steps, which run
//    unrolled, so no load lies on the chain; a padded row pitch keeps the
//    lanes' reads off each other's banks;
//  - the ratios leave the chain: a tile's quotients are formed after its
//    steps with one range check (not one a quotient, each with its own
//    branch) and go out through a tile in shared memory, a tile's values
//    of a row contiguous in device memory.
// Measured (kernel_ab.py, CUDA-graph replays, NVIDIA H100 80GB HBM3,
// 700.00 W): 0.0162 ms in float, 0.0207 in double at 3,040 x 192 (the body
// of one thread a row: 0.0561 / 0.0767); 0.2934 / 0.3316 at 3,040 x 2048
// (1.2026 / 1.5531); one block alone, the chain, 0.0155 / 0.0195: the
// chain binds, at ~160 cycles a step with the tile work in the same warp.
// Kept from variant runs in turns: tiles of 8 steps (4: 0.0196 / 0.0237;
// 16, whose unrolled code is twice as long: 0.0350 / 0.0406), 4 stages.
#include <cuda_runtime.h>

#include <type_traits>

#include "pipeline.cuh"
#include "renorm.cuh"
#include "rounded.cuh"

namespace {

using namespace cnf::rn;

constexpr int kRows = 32;   // rows a block; lane l of each warp: row l
constexpr int kTile = 8;    // steps a staged tile
constexpr int kStages = 4;  // tiles in a warp's ring
constexpr int kPitch = kTile + 1;  // a row's slots in a tile, padded
constexpr int kRP = kRows * kPitch;
// the shared memory a block may take on sm_90 (227 KB)
constexpr size_t kSmemMax = 232448;

// mass below 1e-10: scale by 1e20 (relskew._renorm)
template <typename T>
__device__ __forceinline__ void renorm(T& s0, T& s1) {
  if (add(s0, s1) < T(1e-10)) {
    s0 = mul(s0, T(1e20));
    s1 = mul(s1, T(1e20));
  }
}

// s * (r, 1 - r) + flip(s) * (1 - r, r)  (relskew._trans)
template <typename T>
__device__ __forceinline__ void trans(T& s0, T& s1, T r) {
  const T nb = sub(T(1), r);
  const T t0 = add(mul(s0, r), mul(s1, nb));
  const T t1 = add(mul(s1, r), mul(s0, nb));
  s0 = t0;
  s1 = t1;
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// values in a warp's ring slot: hw, rh (and, with the states in device
// memory, the partner pairs, [row][step][2])
template <bool OnChip>
__host__ __device__ constexpr int slot_values() {
  return (OnChip ? 2 : 4) * kRP;
}

// a block's shared memory: per warp the ring and the ratio tile, then
// (on chip) the stored states [2][M - 1][kRows]
template <typename T, bool OnChip>
size_t smem_bytes(int M) {
  const size_t warp = (size_t)kStages * slot_values<OnChip>() + kRP;
  const size_t states = OnChip ? (size_t)2 * (M > 1 ? M - 1 : 0) * kRows : 0;
  return (2 * warp + states) * sizeof(T);
}

// with the states in device memory, a block's shared memory fits
static_assert(2 * ((size_t)kStages * slot_values<false>() + kRP) *
                      sizeof(double) <=
                  kSmemMax,
              "relskew: the ring and the ratio tiles exceed shared memory");

template <typename T>
bool on_chip(int M) {
  return smem_bytes<T, true>(M) <= kSmemMax;
}

// the ratios q1 / den of a tile, each bit for bit the IEEE quotient: both
// scaled by the power of two that brings den into [1, 2), which is exact
// where the scaled q1 is a normal number, then the fast path's arithmetic
// (csrc/renorm.cuh) for all, with one range check for the tile instead of
// one a quotient on the steps' chain; q1 / den of the unscaled values where
// any operand lies outside the range
template <typename T>
__device__ __forceinline__ void ratios(T (&q1)[kTile],
                                       const T (&den)[kTile]) {
  bool fast = true;
  T q[kTile];
#pragma unroll
  for (int d = 0; d < kTile; ++d) {
    const T k = cnf::Pow2<T>::pow2(cnf::Pow2<T>::exponent(fabs(den[d])), 0);
    const T x = q1[d] * k, y = den[d] * k;
    fast &= (y != T(0)) & cnf::div_safe(y) & cnf::div_safe(x);
    q[d] = cnf::div_finish(x, y, cnf::div_reciprocal(y));
  }
  if (!fast) {
#pragma unroll
    for (int d = 0; d < kTile; ++d) q[d] = div(q1[d], den[d]);
  }
#pragma unroll
  for (int d = 0; d < kTile; ++d) q1[d] = q[d];
}

// warp 0 forward, warp 1 backward over the rows n0 .. n0 + 31
template <typename T, bool OnChip>
__global__ void __launch_bounds__(64)
    relskew_kernel(const T* __restrict__ hw, const T* __restrict__ rh,
                   T* __restrict__ scratch, T* __restrict__ ratio, int N,
                   int M, int hw_stride, int rh_stride) {
  constexpr int SV = slot_values<OnChip>();
  extern __shared__ __align__(16) unsigned char relskew_smem[];
  T* const base = reinterpret_cast<T*>(relskew_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool fwd = warp == 0;
  T* const ring = base + (size_t)warp * (kStages * SV + kRP);
  T* const out = ring + kStages * SV;
  // on chip: the stored states [M - 1][kRows], each of the pair
  T* const st0 = base + 2 * (kStages * SV + kRP);
  T* const st1 = st0 + (size_t)(M - 1) * kRows;
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - n0);
  const int n = n0 + lane;
  const bool live = lane < rows;
  // forward step j: marker m = j (hw m, rh m); backward step j: marker
  // m = M - 2 - j (hw m + 1, rh m).  Phase 1: the forward's markers below
  // `mid`, the backward's from `mid` up.
  const int mid = M / 2;
  const int steps = fwd ? M : M - 1;
  const int p1 = fwd ? mid : M - 1 - mid;
  using P2 = typename Pair<T>::type;

  // the partner pairs of steps [a, b) of tile t into its slot (lane: its
  // own row)
  auto stage_partners = [&](int t, int a, int b) {
    T* pa = ring + (t % kStages) * SV + 2 * kRP;
    for (int j = a; j < b; ++j) {
      const int m = fwd ? j : M - 2 - j;
      if (live && m <= M - 2)
        cnf::copy_async<(int)(2 * sizeof(T))>(
            pa + (lane * kPitch + j % kTile) * 2,
            scratch + ((size_t)m * N + n) * 2);
    }
  };
  // the tile copies: lane (cr, cd) takes step column cd of the rows
  // cr, cr + kRowStep, ...
  constexpr int kRowStep = 32 / kTile;
  const int cr = lane / kTile, cd = lane % kTile;
  // tile t's hw and rh (and its partner pairs) as one commit group
  auto stage = [&](int t, bool partners) {
    T* slot = ring + (t % kStages) * SV;
    const int j0 = t * kTile, j = j0 + cd;
    if (j0 < steps) {
      if (j < steps) {
        const size_t row = (size_t)(n0 + cr);
        const T* hs = hw + row * hw_stride + (fwd ? j : M - 1 - j);
        const T* rs = rh + row * rh_stride + (fwd ? j : M - 2 - j);
        T* hd = slot + cr * kPitch + cd;
#pragma unroll
        for (int i = 0; i < kRows / kRowStep; ++i)
          if (cr + i * kRowStep < rows) {
            cnf::copy_async<(int)sizeof(T)>(
                hd + i * kRowStep * kPitch,
                hs + (size_t)i * kRowStep * hw_stride);
            cnf::copy_async<(int)sizeof(T)>(
                hd + kRP + i * kRowStep * kPitch,
                rs + (size_t)i * kRowStep * rh_stride);
          }
      }
      if (partners) stage_partners(t, j0, min(j0 + kTile, steps));
    }
    cnf::commit_group();
  };

  int next = 0;
  for (; next < kStages - 1; ++next) stage(next, false);
  T s0 = T(0.5), s1 = T(0.5);
  // steps [j0 + da, j0 + db) of tile t of the pass (forward or not, phase
  // 2 or 1, whole tile or not, each known at compile time): the tile's
  // values come out of shared memory into registers before its steps,
  // which run unrolled, so that no load lies on the chain and a whole
  // tile's steps, ratios and copies are one block of straight code
  auto tile = [&](auto fwd_c, auto phase2_c, auto whole_c, int t, int da,
                  int db) {
    constexpr bool kFwd = decltype(fwd_c)::value;
    constexpr bool phase2 = decltype(phase2_c)::value;
    if (decltype(whole_c)::value) {
      da = 0;
      db = kTile;
    }
    const int j0 = t * kTile;
    const T* slot = ring + (t % kStages) * SV;
    T h[kTile], r[kTile], b0[kTile], b1[kTile];
#pragma unroll
    for (int d = 0; d < kTile; ++d) {
      h[d] = slot[lane * kPitch + d];
      r[d] = slot[kRP + lane * kPitch + d];
      b0[d] = b1[d] = T(0);
      const int m = kFwd ? j0 + d : M - 2 - j0 - d;
      if (phase2 && d >= da && d < db && m <= M - 2) {
        if (OnChip) {
          b0[d] = st0[m * kRows + lane];
          b1[d] = st1[m * kRows + lane];
        } else {
          b0[d] = slot[2 * kRP + (lane * kPitch + d) * 2];
          b1[d] = slot[2 * kRP + (lane * kPitch + d) * 2 + 1];
        }
      }
    }
    T q1[kTile], den[kTile];
#pragma unroll
    for (int d = 0; d < kTile; ++d) {
      q1[d] = T(0);
      den[d] = T(1);
      if (d < da || d >= db) continue;  // uniform over the warp
      const int m = kFwd ? j0 + d : M - 2 - j0 - d;
      s0 = mul(s0, sub(T(1), h[d]));
      s1 = mul(s1, h[d]);
      if (!kFwd) {
        trans(s0, s1, r[d]);
        renorm(s0, s1);
      }
      if (!phase2) {  // the pass's state at m, for the other pass
        if (OnChip) {
          st0[m * kRows + lane] = s0;
          st1[m * kRows + lane] = s1;
        } else if (live) {
          reinterpret_cast<P2*>(scratch)[(size_t)m * N + n] = P2{s0, s1};
        }
      } else if (kFwd && m == M - 1) {  // no backward state there
        q1[d] = s1;
        den[d] = add(s0, s1);
      } else {  // rf = s * partner, the ratio rf1 / (rf0 + rf1)
        const T x0 = mul(b0[d], s0);
        q1[d] = mul(b1[d], s1);
        den[d] = add(x0, q1[d]);
      }
      if (kFwd) {
        renorm(s0, s1);
        trans(s0, s1, r[d]);
      }
    }
    if (phase2) {  // the tile's ratios out, a row's values contiguous
      ratios(q1, den);
#pragma unroll
      for (int d = 0; d < kTile; ++d) out[lane * kPitch + d] = q1[d];
      __syncwarp();
      if (cd >= da && cd < db) {
        T* at = ratio + (size_t)(n0 + cr) * M +
                (kFwd ? j0 + cd : M - 2 - j0 - cd);
#pragma unroll
        for (int i = 0; i < kRows / kRowStep; ++i)
          if (cr + i * kRowStep < rows)
            at[(size_t)i * kRowStep * M] =
                out[(cr + i * kRowStep) * kPitch + cd];
      }
      __syncwarp();
    }
  };
  // steps [ja, jb) of the pass, a tile at a time
  auto run = [&](auto fwd_c, auto phase2_c, int ja, int jb) {
    const std::true_type whole{};
    const std::false_type part{};
    for (int t = ja / kTile; t * kTile < jb; ++t) {
      const int j0 = t * kTile;
      if (j0 >= ja) {  // the tile's first visit
        cnf::wait_groups<kStages - 2>();
        __syncwarp();
        // into the slot of tile t - 1, which every lane has passed
        stage(next++, decltype(phase2_c)::value && !OnChip);
      }
      const int da = max(ja - j0, 0), db = min(jb - j0, kTile);
      if (da == 0 && db == kTile)
        tile(fwd_c, phase2_c, whole, t, da, db);
      else
        tile(fwd_c, phase2_c, part, t, da, db);
    }
  };
  const std::true_type yes{};
  const std::false_type no{};
  if (fwd)
    run(yes, no, 0, p1);
  else
    run(no, no, 0, p1);
  __syncthreads();  // each pass's phase-1 states are stored
  if (!OnChip && p1 < steps) {
    // the partner pairs of the steps already staged, as one group
    for (int t = p1 / kTile; t < next; ++t)
      stage_partners(t, max(t * kTile, p1), min((t + 1) * kTile, steps));
    cnf::commit_group();
    cnf::wait_groups<0>();
    __syncwarp();
  }
  if (fwd)
    run(yes, yes, p1, steps);
  else
    run(no, yes, p1, steps);
  cnf::wait_groups<0>();
}

// the kernel may take up to kSmemMax bytes of shared memory (set once a
// device)
template <typename T, bool OnChip>
cudaError_t allow_smem() {
  constexpr int kDevices = 64;
  static bool done[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(relskew_kernel<T, OnChip>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemMax);
  if (err == cudaSuccess && dev < kDevices) done[dev] = true;
  return err;
}

template <typename T, bool OnChip>
int launch_body(const T* hw, const T* rh, T* scratch, T* ratio, int N,
                int M, int hw_stride, int rh_stride, cudaStream_t stream) {
  const cudaError_t err = allow_smem<T, OnChip>();
  if (err != cudaSuccess) return (int)err;
  relskew_kernel<T, OnChip>
      <<<(N + kRows - 1) / kRows, 64, smem_bytes<T, OnChip>(M), stream>>>(
          hw, rh, scratch, ratio, N, M, hw_stride, rh_stride);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_relskew(const T* hw, const T* rh, T* scratch, T* ratio, int N,
                   int M, int hw_stride, int rh_stride, void* stream) {
  if (N < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (on_chip<T>(M))
    return launch_body<T, true>(hw, rh, nullptr, ratio, N, M, hw_stride,
                                rh_stride, s);
  // the pairs are written and staged 2 x sizeof(T) at a time
  if (scratch == nullptr || ((size_t)scratch % (2 * sizeof(T))) != 0)
    return (int)cudaErrorInvalidValue;
  return launch_body<T, false>(hw, rh, scratch, ratio, N, M, hw_stride,
                               rh_stride, s);
}

}  // namespace

extern "C" {

// 1 if cnf_relskew_ratio_* needs the [M - 1, N, 2] scratch at M markers
// (f64: 0 or 1), else 0
int cnf_relskew_scratch(int M, int f64) {
  return f64 ? !on_chip<double>(M) : !on_chip<float>(M);
}

int cnf_relskew_ratio_f32(const float* hw, const float* rh, float* scratch,
                          float* ratio, int N, int M, int hw_stride,
                          int rh_stride, void* stream) {
  return launch_relskew<float>(hw, rh, scratch, ratio, N, M, hw_stride,
                               rh_stride, stream);
}

int cnf_relskew_ratio_f64(const double* hw, const double* rh,
                          double* scratch, double* ratio, int N, int M,
                          int hw_stride, int rh_stride, void* stream) {
  return launch_relskew<double>(hw, rh, scratch, ratio, N, M, hw_stride,
                                rh_stride, stream);
}

}  // extern "C"
