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
// Bound on the H100: memory (2 x 512 loads per pair against 3 x 9 x 256
// butterflies); the 128 outputs are written straight in the final
// [B, M, 128] layout.  Design: one warp per (m, r), 16 values per lane
// (x = lane*16 + i): butterflies of stride < 16 stay inside the lane,
// strides 16..256 go through __shfl_xor_sync.  Consecutive warps of a
// block take consecutive units of one marker, so a block's loads of one
// feature row share cache sectors.
#include <cuda_runtime.h>

#include <cfloat>

#include "blocks.cuh"

namespace {

constexpr int kWarps = 8;

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

template <typename T>
__device__ __forceinline__ void wht512(T (&v)[16], int lane) {
#pragma unroll
  for (int h = 1; h < 16; h <<= 1)
#pragma unroll
    for (int i = 0; i < 16; i += 2 * h)
#pragma unroll
      for (int j = i; j < i + h; ++j) {
        const T a = v[j], b = v[j + h];
        v[j] = a + b;
        v[j + h] = a - b;
      }
#pragma unroll
  for (int bit = 1; bit < 32; bit <<= 1) {
    const bool upper = lane & bit;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const T other = __shfl_xor_sync(0xffffffffu, v[i], bit);
      v[i] = upper ? other - v[i] : v[i] + other;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    turn_kernel(const T* __restrict__ fw_post, const T* __restrict__ bw,
                const T* __restrict__ fw_post_f, const T* __restrict__ bw_f,
                const int* __restrict__ sh, const T* __restrict__ desc,
                const int* __restrict__ idx, T* __restrict__ out, int M,
                int R, int B) {
  __shared__ T dsh[kWarps][512];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kWarps + warp;
  if (pair >= (long long)M * B) return;
  const int m = (int)(pair / B), r = (int)(pair % B);
  const size_t stride = R;

  const int shig = sh[r];
  const T big = T(-1e38);
  T ffm = big, bfm = T(0);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const T ff = fw_post_f[((size_t)m * 8 + n) * stride + r];
    const T bf = bw_f[((size_t)m * 8 + n) * stride + r];
    const T ffa = (n & shig) == 0 ? ff : big;
    ffm = n == 0 ? ffa : fmax(ffm, ffa);
    bfm = n == 0 ? bf : fmax(bfm, bf);
  }
  const int n = lane >> 2;  // shift of this lane's 16 features
  const T ffn = fw_post_f[((size_t)m * 8 + n) * stride + r];
  const T fexp = (n & shig) == 0 ? exp(ffn - ffm) : T(0);
  const T bexp = exp(bw_f[((size_t)m * 8 + n) * stride + r] - bfm);

  T f[16], b[16];
  const size_t base = (size_t)m * 512 * stride + r;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const size_t x = lane * 16 + i;
    f[i] = fw_post[base + x * stride] * fexp;
    b[i] = bw[base + x * stride] * bexp;
  }
  wht512(f, lane);
  wht512(b, lane);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] *= b[i];
  wht512(f, lane);
#pragma unroll
  for (int i = 0; i < 16; ++i) dsh[warp][lane * 16 + i] = f[i] * T(1.0 / 512.0);
  __syncwarp();

  const T tiny = Tiny<T>::v();
  const T v0 = dsh[warp][0];
  const T logv0 = log(v0 > tiny ? v0 : tiny);
  const T d = desc[r];
  T* o = out + ((size_t)r * M + m) * 128;
#pragma unroll
  for (int t = lane; t < 128; t += 32) {
    const T v = dsh[warp][idx[t]];
    const T logv = log(v > tiny ? v : tiny);
    const T w = (v > T(0) && v0 > T(0)) ? logv - logv0 : T(cnf::kMinFactor);
    o[t] = w * d;
  }
}

template <typename T>
int launch_turn(const T* fw_post, const T* bw, const T* fw_post_f,
                const T* bw_f, const int* sh, const T* desc, const int* idx,
                T* out, int M, int R, int B, void* stream) {
  if (M <= 0 || B <= 0) return 0;
  const long long pairs = (long long)M * B;
  const dim3 grid((unsigned)((pairs + kWarps - 1) / kWarps));
  turn_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
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

}  // extern "C"
