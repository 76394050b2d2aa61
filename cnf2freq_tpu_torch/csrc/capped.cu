// The capped-gradient parameter updates: for every lane, the bisection
// that finds x with  integral of 1 / grad from the current value to x =
// scalefactor  (at most 51 steps, each with a 15-point Gauss-Legendre
// quadrature), then the odds change capped at 3x.
//
// A kernel for an XLA program of the JAX package, not for a Pallas
// kernel: cnf2freq_tpu/updates/capped.py::cappedgd, whose lax.while_loop
// (:145) parameter_updates.make_jitted_updates (:158-171) jits whole, so
// the TPU ran the update with no host round trip.  The port's plain twin,
// updates/capped.py::cappedgd, is a Python loop of eager operations that
// waits on the host once a step (its all-done test) and launches some 30
// elementwise kernels for each of a step's 16 gradient evaluations.
//   cnf_capped_haplo_*    the haploweight lanes [N, M]
//                         (parameter_updates.update_haploweights): the
//                         pseudo-likelihood gradient plus the entropy and
//                         relskew terms, breakathalf per lane;
//   cnf_capped_infprob_*  the genotype lanes [N, M, 2, 2]
//                         (parameter_updates.update_infprobs): the
//                         pseudo-likelihood gradient plus the entropy and
//                         prior terms; a lane whose accumulated mass is
//                         not above 0 is skipped (value 0, no hit: its
//                         update is discarded).
// The gradient is a functor (HaploGrad, InfprobGrad) on top of one
// pseudo_likelihood_grad.
//
// One thread owns a lane and runs its whole bisection in registers, until
// the lane is done or 51 steps have passed: the twin freezes done lanes,
// so a lane's own early stop is its result exactly.  Every rule of the
// twin is kept: caplogitchange at the start and the end, dead lanes (a
// non-finite starting inverse gradient, a flat lane: one whose inverse
// gradient is finite and above the dtype's rounding-floor limit, or a zero
// scalefactor), out-of-bounds, narrow (< 1e-10) and the sf * 1e-3
// tolerance, the (sf + 0.1) * 1.1 substitute of a bad step and the sign
// of the quadrature.  The arithmetic is the twin's, operation for
// operation and rounded as its separate kernels round it (rounded.cuh):
// a bisection decision near the tolerance, or a cap near 1 - eps, goes
// the same way as in the twin.  In particular w / g in the twin's
// quadrature is PyTorch's float-by-tensor division, reciprocal(g) * w,
// and the scalars come from the wrapper in the twin's own rounding (sf *
// 1e-3 and (sf + 0.1) * 1.1 in double, then in the lane type).
//
// Bound on the H100: operations.  A lane reads about 10 values and
// writes 2, ~0.1 ms of bytes at 1000 x 192 even in float64; a lane-step is
// 16 gradient evaluations of ~60 operations and 3 logs each, and lanes
// take up to 51 steps.  No tile, no product and no reduction across
// threads: lanes are independent.  Lanes stop at different steps, so a
// warp runs for its slowest lane (the divergence is accepted here).  No
// fast math: the logs and quotients stay exact.
#include <cuda_runtime.h>

#include "rounded.cuh"

namespace {

using namespace cnf::rn;

constexpr int kThreads = 128;
constexpr int kNodes = 15;

// np.polynomial.legendre.leggauss(15), the plain twin's nodes and weights
// (17 significant digits: each is the twin's double exactly, and its
// float the twin's float)
__constant__ double kGlX[kNodes] = {
    -0.98799251802048538, -0.93727339240070595, -0.84820658341042721,
    -0.72441773136017007, -0.57097217260853883, -0.39415134707756339,
    -0.20119409399743451, 0.0, 0.20119409399743451, 0.39415134707756339,
    0.57097217260853883, 0.72441773136017007, 0.84820658341042721,
    0.93727339240070595, 0.98799251802048538};
__constant__ double kGlW[kNodes] = {
    0.030753241996118647, 0.070366047488108069, 0.10715922046717177,
    0.13957067792615391, 0.16626920581699378, 0.18616100001556188,
    0.19843148532711125, 0.2025782419255609, 0.19843148532711125,
    0.18616100001556188, 0.16626920581699378, 0.13957067792615391,
    0.10715922046717177, 0.070366047488108069, 0.030753241996118647};

// The expanded gradient of parameter_updates.pseudo_likelihood_grad with
// (y, g, h) = (current probability, posterior-weighted count, total
// count), its terms in the twin's order.
template <typename T>
__device__ __forceinline__ T pseudo_likelihood_grad(T y, T g, T h, T x) {
  const T lx = ln(x);
  const T l1x = ln(sub(T(1), x));
  const T yg = mul(y, g), yh = mul(y, h);
  const T yg2 = mul(yg, yg), yh2 = mul(yh, yh);
  const T yygh = mul(mul(mul(y, y), g), h);
  const T ygg = mul(yg, g), ygh = mul(yg, h);
  T s = add(mul(-yg2, lx), mul(yg2, l1x));
  s = add(s, mul(yygh, lx));
  s = sub(s, mul(yygh, l1x));
  s = sub(s, yygh);
  s = sub(s, mul(yh2, x));
  s = add(s, yh2);
  s = add(s, mul(ygg, lx));
  s = sub(s, mul(ygg, l1x));
  s = add(s, ygg);
  s = add(s, mul(mul(mul(mul(T(2), y), g), h), x));
  s = sub(s, mul(ygh, lx));
  s = add(s, mul(ygh, l1x));
  s = sub(s, ygh);
  s = sub(s, mul(mul(g, g), x));
  T u = add(yg, mul(yh, x));
  u = sub(u, yh);
  u = sub(u, mul(g, x));
  return div(-s, mul(u, u));
}

// log(1 / x - 1), the entropy term's log (1 / x is reciprocal(x) * 1)
template <typename T>
__device__ __forceinline__ T log_odds_inv(T x) {
  return ln(sub(div(T(1), x), T(1)));
}

// update_haploweights' gradient: base + (1 - sim) * ef * log(1 / x - 1)
// + (rel - x) / (x - x * x) * desc; ent is (1 - sim) * ef
template <typename T>
struct HaploGrad {
  T y, g, h, ent, rel, desc;
  __device__ __forceinline__ T operator()(T x) const {
    const T base = pseudo_likelihood_grad(y, g, h, x);
    const T e = mul(ent, log_odds_inv(x));
    const T r = mul(div(sub(rel, x), sub(x, mul(x, x))), desc);
    return add(add(base, e), r);
  }
};

// update_infprobs' gradient: base + ef * (log(1 / x - 1) + prior)
template <typename T>
struct InfprobGrad {
  T y, g, h, prior, ef;
  __device__ __forceinline__ T operator()(T x) const {
    const T base = pseudo_likelihood_grad(y, g, h, x);
    return add(base, mul(add(log_odds_inv(x), prior), ef));
  }
};

template <typename T>
struct Capped {
  T value;
  bool hit;
};

// capped.caplogitchange with nnn = 3
template <typename T>
__device__ __forceinline__ Capped<T> caplogitchange(T intended, T orig,
                                                    T eps, bool brk) {
  const T limn = mul(mul(T(2), orig), sub(orig, T(1)));
  const T limd1 = sub(T(-1), mul(T(2), orig));
  const T limd2 = sub(mul(T(2), orig), T(3));
  intended = minimum(maximum(intended, eps), sub(T(1), eps));
  const T diff = sub(intended, orig);
  const T hi = div(limn, limd1);
  const T lo = div(-limn, limd2);
  const bool over = diff > hi, under = diff < lo;
  T out = over ? add(orig, hi) : (under ? add(orig, lo) : intended);
  const bool hit = (over && out < T(0.5)) || (under && out > T(0.5));
  if (brk && mul(sub(out, T(0.5)), sub(orig, T(0.5))) < T(0))
    out = mul(T(0.5), add(T(0.5), orig));
  return {out, hit};
}

// The scalars of one update, each in the twin's rounding.
template <typename T>
struct Step {
  T sf;          // the scalefactor
  T tol;         // sf * 1e-3
  T subst;       // (sf + 0.1) * 1.1, a bad step's integral
  T flat_limit;  // capped.flat_lanes' limit on |1 / grad| for the dtype
  int frozen;    // sf == 0: every lane is dead
  int iters;     // the most bisection steps
};

// capped.cappedgd for one lane
template <typename T, typename Grad>
__device__ Capped<T> capped_lane(const Grad& grad, T orig, T eps, bool brk,
                                 const Step<T>& st) {
  const T eps_hi = sub(T(1), eps);
  auto clip = [&](T v) { return minimum(maximum(v, eps), eps_hi); };
  const T lolim = caplogitchange(eps, orig, eps, brk).value;
  const T hilim = caplogitchange(eps_hi, orig, eps, brk).value;
  const T lo0 = sub(lolim, mul(eps, T(0.125)));
  const T hi0 = add(hilim, mul(eps, T(0.125)));
  const T origc = caplogitchange(orig, orig, eps, brk).value;

  const T g0 = div(T(1), grad(clip(origc)));
  const bool dead = !isfinite(g0) || fabs(g0) > st.flat_limit || st.frozen;
  const bool lowside = g0 < T(0);
  T lo = (dead || !lowside) ? origc : lo0;
  T hi = (dead || lowside) ? origc : hi0;

  bool done = dead;
  for (int it = 0; it < st.iters && !done; ++it) {
    done = (lo > hilim) || (hi < lolim);
    const T mid = mul(T(0.5), add(lo, hi));
    const T gv = div(T(1), grad(clip(mid)));
    const bool bad = ((gv < T(0)) != lowside) || !isfinite(gv);
    const T start = minimum(origc, mid);
    const T end = maximum(origc, mid);
    done = done || (sub(end, start) < T(1e-10) && !bad);
    const T qmid = mul(T(0.5), add(start, end));
    const T qhalf = mul(T(0.5), sub(end, start));
    T acc = T(0);
#pragma unroll 1
    for (int i = 0; i < kNodes; ++i) {
      const T x = clip(add(qmid, mul(qhalf, T(kGlX[i]))));
      acc = add(acc, mul(div(T(1), grad(x)), T(kGlW[i])));
    }
    T prel = mul(acc, qhalf);
    if (end != mid) prel = -prel;
    if (bad || !isfinite(prel)) prel = st.subst;
    done = done || fabs(sub(prel, st.sf)) < st.tol;
    const bool go_up = (prel < st.sf) != lowside;
    if (!done) {
      if (go_up)
        lo = mid;
      else
        hi = mid;
    }
  }
  return caplogitchange(mul(T(0.5), add(lo, hi)), orig, eps, brk);
}

// lanes [L], row r = lane / per_row: w, B, C, sim, rel, brk per lane,
// desc and eps per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    capped_haplo_kernel(const T* __restrict__ w, const T* __restrict__ B,
                        const T* __restrict__ C, const T* __restrict__ sim,
                        const T* __restrict__ rel, const T* __restrict__ desc,
                        const T* __restrict__ eps,
                        const unsigned char* __restrict__ brk,
                        T* __restrict__ out, unsigned char* __restrict__ hit,
                        int L, int per_row, T ef, Step<T> st) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < L;
       i += gridDim.x * blockDim.x) {
    const int r = i / per_row;
    const HaploGrad<T> grad{w[i], B[i], C[i], mul(sub(T(1), sim[i]), ef),
                            rel[i], desc[r]};
    const Capped<T> c = capped_lane(grad, w[i], eps[r], brk[i] != 0, st);
    out[i] = c.value;
    hit[i] = c.hit;
  }
}

// lanes [L] of [N, M, 2, 2] (candidate allele minor), row r = lane /
// per_row: cp, a, prior per lane, t per (lane / 2), eps per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    capped_infprob_kernel(const T* __restrict__ cp, const T* __restrict__ a,
                          const T* __restrict__ t,
                          const T* __restrict__ prior,
                          const T* __restrict__ eps, T* __restrict__ out,
                          unsigned char* __restrict__ hit, int L,
                          int per_row, T ef, Step<T> st) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < L;
       i += gridDim.x * blockDim.x) {
    const T g = a[i];
    if (!(g > T(0))) {
      out[i] = T(0);
      hit[i] = 0;
      continue;
    }
    const InfprobGrad<T> grad{cp[i], g, t[i >> 1], prior[i], ef};
    const Capped<T> c = capped_lane(grad, cp[i], eps[i / per_row], false,
                                    st);
    out[i] = c.value;
    hit[i] = c.hit;
  }
}

int grid_for(int L) {
  const long long blocks = ((long long)L + kThreads - 1) / kThreads;
  return (int)(blocks < (1 << 30) ? blocks : (1 << 30));
}

template <typename T>
Step<T> make_step(T sf, T tol, T subst, T flat_limit, int frozen,
                  int iters) {
  return Step<T>{sf, tol, subst, flat_limit, frozen, iters};
}

template <typename T>
int launch_haplo(const T* w, const T* B, const T* C, const T* sim,
                 const T* rel, const T* desc, const T* eps,
                 const unsigned char* brk, T* out, unsigned char* hit, int L,
                 int per_row, T ef, T sf, T tol, T subst, T flat_limit,
                 int frozen, int iters, void* stream) {
  if (L < 0 || per_row <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  capped_haplo_kernel<T><<<grid_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      w, B, C, sim, rel, desc, eps, brk, out, hit, L, per_row, ef,
      make_step(sf, tol, subst, flat_limit, frozen, iters));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_infprob(const T* cp, const T* a, const T* t, const T* prior,
                   const T* eps, T* out, unsigned char* hit, int L,
                   int per_row, T ef, T sf, T tol, T subst, T flat_limit,
                   int frozen, int iters, void* stream) {
  if (L < 0 || L % 2 != 0 || per_row <= 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  capped_infprob_kernel<T>
      <<<grid_for(L), kThreads, 0, (cudaStream_t)stream>>>(
          cp, a, t, prior, eps, out, hit, L, per_row, ef,
          make_step(sf, tol, subst, flat_limit, frozen, iters));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cnf_capped_haplo_f32(const float* w, const float* B, const float* C,
                         const float* sim, const float* rel,
                         const float* desc, const float* eps,
                         const unsigned char* brk, float* out,
                         unsigned char* hit, int L, int per_row, float ef,
                         float sf, float tol, float subst, float flat_limit,
                         int frozen, int iters, void* stream) {
  return launch_haplo<float>(w, B, C, sim, rel, desc, eps, brk, out, hit, L,
                             per_row, ef, sf, tol, subst, flat_limit, frozen,
                             iters, stream);
}

int cnf_capped_haplo_f64(const double* w, const double* B, const double* C,
                         const double* sim, const double* rel,
                         const double* desc, const double* eps,
                         const unsigned char* brk, double* out,
                         unsigned char* hit, int L, int per_row, double ef,
                         double sf, double tol, double subst,
                         double flat_limit, int frozen, int iters,
                         void* stream) {
  return launch_haplo<double>(w, B, C, sim, rel, desc, eps, brk, out, hit,
                              L, per_row, ef, sf, tol, subst, flat_limit,
                              frozen, iters, stream);
}

int cnf_capped_infprob_f32(const float* cp, const float* a, const float* t,
                           const float* prior, const float* eps, float* out,
                           unsigned char* hit, int L, int per_row, float ef,
                           float sf, float tol, float subst,
                           float flat_limit, int frozen, int iters,
                           void* stream) {
  return launch_infprob<float>(cp, a, t, prior, eps, out, hit, L, per_row,
                               ef, sf, tol, subst, flat_limit, frozen, iters,
                               stream);
}

int cnf_capped_infprob_f64(const double* cp, const double* a,
                           const double* t, const double* prior,
                           const double* eps, double* out,
                           unsigned char* hit, int L, int per_row, double ef,
                           double sf, double tol, double subst,
                           double flat_limit, int frozen, int iters,
                           void* stream) {
  return launch_infprob<double>(cp, a, t, prior, eps, out, hit, L, per_row,
                                ef, sf, tol, subst, flat_limit, frozen,
                                iters, stream);
}

}  // extern "C"
