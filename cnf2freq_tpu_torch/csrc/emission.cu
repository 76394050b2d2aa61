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
// Bound on the H100: the 512 stores per pair (M*512*R values, 403 MB at
// M=192, R=1024 in f32) against ~200 bytes of slot loads; the arithmetic
// (2 x 256 parent-block entries, each a handful of grandparent terms) is
// far below the card's FLOP rate.  Design: one thread per (m, r), the
// unit index fastest, so every load and every one of the 512 stores is
// coalesced across a warp's 32 consecutive units; the path sums stay in
// registers and nothing bigger than e is ever written.
#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

template <typename T>
__global__ void emission_kernel(const int* __restrict__ md,
                                const T* __restrict__ ms,
                                const T* __restrict__ hw,
                                const int* __restrict__ ex,
                                const int* __restrict__ at,
                                T* __restrict__ e, int M, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (r >= R) return;
  cnf::Slot<T> sl[7];
#pragma unroll
  for (int s = 0; s < 7; ++s)
    sl[s] = cnf::load_slot(md, ms, hw, ex, at, s, m, r, M, R);
  cnf::Root<T> root;
  cnf::root_block(sl[0], 0, 0, root);

  T* out = e + (size_t)m * 512 * R + r;
  if (sl[0].attop) {
    // focal top: the root term alone, constant over states and the
    // upper shift bits
    const T tops0 = root.froot[0][0] + root.froot[1][0];
    const T tops1 = root.froot[0][1] + root.froot[1][1];
    for (int x = 0; x < 512; ++x)
      out[(size_t)x * R] = ((x >> 6) & 1) ? tops1 : tops0;
    return;
  }

  // path-summed parent blocks pbs[k][r0][fp][sk]
  T pbs[2][2][8][2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const cnf::Slot<T>& par = sl[1 + 3 * k];
    const cnf::Slot<T>& g0 = sl[2 + 3 * k];
    const cnf::Slot<T>& g1 = sl[3 + 3 * k];
#pragma unroll
    for (int r0 = 0; r0 < 2; ++r0) {
      const int v = k == 0 ? root.vA[r0] : root.vB[r0];
      const T sv = k == 0 ? root.svA[r0] : root.svB[r0];
#pragma unroll
      for (int fp = 0; fp < 8; ++fp) {
#pragma unroll
        for (int sk = 0; sk < 2; ++sk) {
          T acc = T(0);
#pragma unroll 1
          for (int fpath = 0; fpath < 8; ++fpath)
            acc += cnf::parent_term(par, g0, g1, v, sv, fp, fpath, sk);
          pbs[k][r0][fp][sk] = acc;
        }
      }
    }
  }

#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int b = 0; b < 8; ++b)
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            T acc = root.froot[0][t] * pbs[0][0][a][u] * pbs[1][0][b][v];
            acc += root.froot[1][t] * pbs[0][1][a][u] * pbs[1][1][b][v];
            const int x = ((v * 2 + u) * 2 + t) * 64 + b * 8 + a;
            out[(size_t)x * R] = acc;
          }
}

template <typename T>
int launch_emission(const int* md, const T* ms, const T* hw, const int* ex,
                    const int* at, T* e, int M, int R, void* stream) {
  if (M <= 0 || R <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((R + 127) / 128, M);
  emission_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
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
