// Turn-weight kernel: posterior-weighted xor-correlation at the 128 turn
// offsets.
//
// Replaces the TPU kernel cnf2freq_tpu/ops/scan_v2.py::_turn_kernel
// (launcher turn_weights_v2_pallas).  Per (marker m, unit r): scale
// fw_post and bw by their per-shift exp factors (disallowed shifts of
// fw_post to 0), take the 512-point WHT (H8 x H64 = H512 over
// x = shift*64 + state) of each, multiply, invert (WHT / 512), read the
// result D at the 128 offsets idx[t] = turn_shift_flip(t)*64 +
// (t & turn_state_mask), and write
//   w[r, m, t] = (D[idx[t]] > 0 && D[0] > 0 ?
//                 log(max(D[idx[t]], tiny)) - log(max(D[0], tiny))
//                 : MINFACTOR) * descendants[r]
// with tiny the smallest normal of the type and big = -1e38 as the
// masked factor maximum.
//
// Two layouts, two entries sharing the butterflies (wht512) and the
// weights' epilogue (write_turns):
//   cnf_turn_*       fw_post, bw [M, 512, R], factors [M, 8, R] (the v2
//                    scan); replaces the TPU kernel above;
//   cnf_turn_bmns_*  fw_post, bw [B, M, 8, 64], factors [B, M, 8] (the
//                    classic scan that carries coherence); replaces the
//                    JAX package's XLA program hmm/probes.py:400
//                    turn_weights_fast, which has no TPU kernel.
// Both write w [B, M, 128].  The notes below are the v2 entry's; the
// [B, M, NS, S] entry's design is at turn_bmns_kernel.
//
// Bound on the H100: memory (2 x 512 loads per pair against 3 x 9 x 256
// butterflies); the 128 outputs are written straight in the final
// [B, M, 128] layout.  In [M, 512, R] one pair's 512 values lie at stride
// R, so a warp that loads one unit touches 32 sectors for 32 words.
// Design: a block takes one marker and U = kUnits consecutive units.
// First U x 8 threads put the per-(unit, shift) exp factors into shared
// memory; then the block stages the [512 x U] tiles of fw_post and bw in
// shared memory with the unit index fastest across threads, so each warp
// load covers whole sectors, scaling by the factors on the way; rows are
// padded by 32/U values so those stores hit 32 distinct banks.  Then one
// warp per unit transforms its 512 values with x = i*32 + lane
// (conflict-free shared reads): strides 32..256 stay in the lane,
// strides 1..16 go through __shfl_xor_sync.  D reuses the unit's fw_post
// row.  Each butterfly stage is its own fixed 16-step loop: written as
// one loop nest over the strides, the two 16-value arrays were left in
// local memory, which cost 3x the time.
//
// Kept U, from a variant run at M=192, B=1000 (U = 8, 16 timed in turns;
// NVIDIA H100 80GB HBM3, 700.00 W): U = 8 in both types, 0.451 ms a
// launch in float (64 registers, 33 KB of tiles a block) and 0.992 ms in
// double (80 registers, 66 KB); U = 16 took 0.682 / 1.287 ms.  The
// warp-per-pair body that loaded straight from device memory took
// 1.502 / 2.780 ms on the same card.
#include <cuda_runtime.h>

#include <cfloat>

#include "blocks.cuh"

namespace {

// units (= warps) a block: 16 was slower in both types
constexpr int kUnits = 8;

template <typename T>
struct Tiny;
template <>
struct Tiny<float> {
  static __device__ __forceinline__ float v() { return FLT_MIN; }
};
template <>
struct Tiny<double> {
  static __device__ __forceinline__ double v() { return DBL_MIN; }
};

// a unit's tile row: 512 values and 32/kUnits of padding
constexpr int kRowLen = 512 + 32 / kUnits;

// butterflies of stride H*32 inside the lane (i and i | H); one fixed
// 16-step loop per stage keeps every index static, so the values stay in
// registers
template <int H, typename T>
__device__ __forceinline__ void lane_stage(T (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if ((i & H) == 0) {
      const T a = v[i], b = v[i | H];
      v[i] = a + b;
      v[i | H] = a - b;
    }
}

// butterflies of stride BIT across the lanes lane and lane ^ BIT
template <int BIT, typename T>
__device__ __forceinline__ void shuffle_stage(T (&v)[16], int lane) {
  const bool upper = (lane & BIT) != 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const T other = __shfl_xor_sync(0xffffffffu, v[i], BIT);
    v[i] = upper ? other - v[i] : v[i] + other;
  }
}

// 512-point WHT over a warp with x = i*32 + lane
template <typename T>
__device__ __forceinline__ void wht512(T (&v)[16], int lane) {
  lane_stage<1>(v);
  lane_stage<2>(v);
  lane_stage<4>(v);
  lane_stage<8>(v);
  shuffle_stage<1>(v, lane);
  shuffle_stage<2>(v, lane);
  shuffle_stage<4>(v, lane);
  shuffle_stage<8>(v, lane);
  shuffle_stage<16>(v, lane);
}

// the 128 weights of one pair from its D (512 values in shared memory),
// scaled by descendants d: lane takes t = lane + 32j
template <typename T>
__device__ __forceinline__ void write_turns(const T* dr,
                                            const int* __restrict__ idx,
                                            T d, T* __restrict__ o,
                                            int lane) {
  const T tiny = Tiny<T>::v();
  const T v0 = dr[0];
  const T logv0 = log(v0 > tiny ? v0 : tiny);
#pragma unroll
  for (int t = lane; t < 128; t += 32) {
    const T v = dr[idx[t]];
    const T logv = log(v > tiny ? v : tiny);
    const T wt = (v > T(0) && v0 > T(0)) ? logv - logv0 : T(cnf::kMinFactor);
    o[t] = wt * d;
  }
}

template <typename T>
__global__ void __launch_bounds__(kUnits * 32)
    turn_kernel(const T* __restrict__ fw_post, const T* __restrict__ bw,
                const T* __restrict__ fw_post_f, const T* __restrict__ bw_f,
                const int* __restrict__ sh, const T* __restrict__ desc,
                const int* __restrict__ idx, T* __restrict__ out, int M,
                int R, int B) {
  constexpr int U = kUnits, L = kRowLen;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ft = reinterpret_cast<T*>(smem);  // [U][L], then D
  T* const bt = ft + U * L;                  // [U][L]
  __shared__ T fexp[U][8], bexp[U][8];
  const int tid = threadIdx.x;
  const int m = blockIdx.y;
  const int r0 = blockIdx.x * U;
  const size_t stride = R;

  // per-(unit, shift) factors, unit fastest
  if (tid < U * 8) {
    const int u = tid % U, n = tid / U, r = r0 + u;
    T fe = T(0), be = T(0);
    if (r < B) {
      const int shig = sh[r];
      const T big = T(-1e38);
      T ffm = big, bfm = T(0);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const T ff = fw_post_f[((size_t)m * 8 + k) * stride + r];
        const T bf = bw_f[((size_t)m * 8 + k) * stride + r];
        const T ffa = (k & shig) == 0 ? ff : big;
        ffm = k == 0 ? ffa : fmax(ffm, ffa);
        bfm = k == 0 ? bf : fmax(bfm, bf);
      }
      const T ffn = fw_post_f[((size_t)m * 8 + n) * stride + r];
      fe = (n & shig) == 0 ? exp(ffn - ffm) : T(0);
      be = exp(bw_f[((size_t)m * 8 + n) * stride + r] - bfm);
    }
    fexp[u][n] = fe;
    bexp[u][n] = be;
  }
  __syncthreads();

  // the [512 x U] tiles: thread (x0 = tid / U, u = tid % U) takes rows
  // x0 + 32k, so a warp's load covers 32/U rows x U units
  {
    const int u = tid % U, x0 = tid / U, r = r0 + u;
    const size_t base = (size_t)m * 512 * stride + r;
    T fv[16], bv[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const size_t at = base + (size_t)(x0 + 32 * k) * stride;
      fv[k] = r < B ? fw_post[at] : T(0);
      bv[k] = r < B ? bw[at] : T(0);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int x = x0 + 32 * k;
      ft[u * L + x] = fv[k] * fexp[u][x >> 6];
      bt[u * L + x] = bv[k] * bexp[u][x >> 6];
    }
  }
  __syncthreads();

  // one warp per unit
  const int lane = tid & 31, w = tid >> 5, r = r0 + w;
  if (r >= B) return;  // whole warps; no block barrier follows
  T* const dr = ft + w * L;
  const T* const br = bt + w * L;
  T f[16], b[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    f[i] = dr[i * 32 + lane];
    b[i] = br[i * 32 + lane];
  }
  wht512(f, lane);
  wht512(b, lane);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] *= b[i];
  wht512(f, lane);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16; ++i) dr[i * 32 + lane] = f[i] * T(1.0 / 512.0);
  __syncwarp();

  write_turns(dr, idx, desc[r], out + ((size_t)r * M + m) * 128, lane);
}

// The [B, M, NS, S] entry: one warp a (unit b, marker m) pair, whose
// 512 values lie contiguous, so lane takes x = i*32 + lane straight from
// device memory (whole sectors) and no tile is staged.  Lane k < 8 of
// each group of 8 reads the shift factors; the masked maxima are taken
// by shuffles in the group and register i takes the factor of shift
// i >> 1 from lane i >> 1.  D goes to the warp's row of shared memory for
// the gather at the 128 offsets.  Bound: bytes, 2 x 512 loads, 16 factor
// loads and 128 stores a pair (0.268 / 0.535 ms in float / double at
// B=1000, M=192).
constexpr int kPairWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kPairWarps * 32)
    turn_bmns_kernel(const T* __restrict__ fw_post, const T* __restrict__ bw,
                     const T* __restrict__ fw_post_f,
                     const T* __restrict__ bw_f, const int* __restrict__ sh,
                     const T* __restrict__ desc, const int* __restrict__ idx,
                     T* __restrict__ out, int M, long long P) {
  __shared__ T dsh[kPairWarps][512];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * kPairWarps + w;
  if (p >= P) return;  // whole warps; no block barrier follows
  const int r = (int)(p / M);
  const size_t base = (size_t)p * 512;

  // shift factors: lane holds shift k = lane & 7
  const int k = lane & 7;
  const bool allowed = (k & sh[r]) == 0;
  const T big = T(-1e38);
  const T ff = fw_post_f[(size_t)p * 8 + k];
  const T bf = bw_f[(size_t)p * 8 + k];
  T ffm = allowed ? ff : big, bfm = bf;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    ffm = fmax(ffm, __shfl_xor_sync(0xffffffffu, ffm, o));
    bfm = fmax(bfm, __shfl_xor_sync(0xffffffffu, bfm, o));
  }
  const T fe = allowed ? exp(ff - ffm) : T(0);
  const T be = exp(bf - bfm);

  T f[16], b[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    f[i] = fw_post[base + i * 32 + lane];
    b[i] = bw[base + i * 32 + lane];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    f[i] *= __shfl_sync(0xffffffffu, fe, i >> 1);
    b[i] *= __shfl_sync(0xffffffffu, be, i >> 1);
  }
  wht512(f, lane);
  wht512(b, lane);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] *= b[i];
  wht512(f, lane);
  T* const dr = dsh[w];
#pragma unroll
  for (int i = 0; i < 16; ++i) dr[i * 32 + lane] = f[i] * T(1.0 / 512.0);
  __syncwarp();
  write_turns(dr, idx, desc[r], out + (size_t)p * 128, lane);
}

template <typename T>
int launch_turn_bmns(const T* fw_post, const T* bw, const T* fw_post_f,
                     const T* bw_f, const int* sh, const T* desc,
                     const int* idx, T* out, int B, int M, void* stream) {
  if (M <= 0 || B <= 0) return 0;
  const long long P = (long long)B * M;
  const long long grid = (P + kPairWarps - 1) / kPairWarps;
  turn_bmns_kernel<T><<<(unsigned)grid, kPairWarps * 32, 0,
                        (cudaStream_t)stream>>>(fw_post, bw, fw_post_f, bw_f,
                                                sh, desc, idx, out, M, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_turn(const T* fw_post, const T* bw, const T* fw_post_f,
                const T* bw_f, const int* sh, const T* desc, const int* idx,
                T* out, int M, int R, int B, void* stream) {
  if (M <= 0 || B <= 0) return 0;
  constexpr size_t smem = 2 * kUnits * kRowLen * sizeof(T);
  // above 48 KB (double) the dynamic shared memory needs the attribute
  cudaError_t err = cudaFuncSetAttribute(
      turn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kUnits - 1) / kUnits, M);
  turn_kernel<T><<<grid, kUnits * 32, smem, (cudaStream_t)stream>>>(
      fw_post, bw, fw_post_f, bw_f, sh, desc, idx, out, M, R, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cnf_turn_f32(const float* fw_post, const float* bw,
                 const float* fw_post_f, const float* bw_f, const int* sh,
                 const float* desc, const int* idx, float* out, int M, int R,
                 int B, void* stream) {
  return launch_turn<float>(fw_post, bw, fw_post_f, bw_f, sh, desc, idx, out,
                            M, R, B, stream);
}

int cnf_turn_f64(const double* fw_post, const double* bw,
                 const double* fw_post_f, const double* bw_f, const int* sh,
                 const double* desc, const int* idx, double* out, int M,
                 int R, int B, void* stream) {
  return launch_turn<double>(fw_post, bw, fw_post_f, bw_f, sh, desc, idx, out,
                             M, R, B, stream);
}

int cnf_turn_bmns_f32(const float* fw_post, const float* bw,
                      const float* fw_post_f, const float* bw_f,
                      const int* sh, const float* desc, const int* idx,
                      float* out, int B, int M, void* stream) {
  return launch_turn_bmns<float>(fw_post, bw, fw_post_f, bw_f, sh, desc, idx,
                                 out, B, M, stream);
}

int cnf_turn_bmns_f64(const double* fw_post, const double* bw,
                      const double* fw_post_f, const double* bw_f,
                      const int* sh, const double* desc, const int* idx,
                      double* out, int B, int M, void* stream) {
  return launch_turn_bmns<double>(fw_post, bw, fw_post_f, bw_f, sh, desc,
                                  idx, out, B, M, stream);
}

}  // extern "C"
