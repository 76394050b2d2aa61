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
// A lane's bisection runs in one thread, in registers, until the lane is
// done or 51 steps have passed: the twin freezes done lanes, so a lane's
// own early stop is its result exactly.  Every rule of the twin is kept:
// caplogitchange at the start and the end, dead lanes (a non-finite
// starting inverse gradient, a flat lane: one whose inverse gradient is
// finite and above the dtype's rounding-floor limit, or a zero
// scalefactor), out-of-bounds, narrow (< 1e-10) and the sf * 1e-3
// tolerance, the (sf + 0.1) * 1.1 substitute of a bad step and the sign
// of the quadrature.  The arithmetic is the twin's, operation for
// operation and rounded as its separate kernels round it (rounded.cuh):
// a bisection decision near the tolerance, or a cap near 1 - eps, goes
// the same way as in the twin.  In particular w / g in the twin's
// quadrature is PyTorch's float-by-tensor division, reciprocal(g) * w,
// and the scalars come from the wrapper in the twin's own rounding (sf *
// 1e-3 and (sf + 0.1) * 1.1 in double, then in the lane type).  The
// gradient's products of (y, g, h) alone are formed once a lane, each as
// the twin rounds it.
//
// Bound on the H100: operations.  A lane reads about 10 values and
// writes 2, ~0.1 ms of bytes at 1000 x 192 even in float64; a lane-step is
// 16 gradient evaluations of ~50 operations and 3 logs each (~3,200 SASS
// instructions in float32, ~6,100 in float64, with the exact logs and
// quotients), and lanes take 1 to 51 steps (16 on average on a real
// genotype update, 4 on a haploweight one).  No tile, no product and no
// reduction across threads: lanes are independent, but a warp issues for
// its slowest thread, and warps of 32 consecutive lanes (a lane a thread)
// would issue 2.2 (genotypes) to 4.1 (float64 haploweights) times the
// lane-steps a real update needs.  So the lanes of a launch form one
// queue: the grid is persistent (as many threads as the card holds at
// once); each warp takes kChunk lanes at a time from a counter that the
// launch zeroes on its stream, and its threads run one bisection step an
// iteration, a thread whose lane ends (done, dead or skipped) taking the
// warp's next lane before the following step.  A warp then waits only for
// the tail of the whole queue (modelled from the real update's steps:
// 1.04-1.13 times the lane-steps for genotypes, 1.6-1.9 for haploweights,
// whose few long lanes end the launch).  A step evaluates the bisection
// point and the 15 quadrature nodes in one loop, two evaluations an
// iteration; a frozen update (scalefactor 0) writes every lane without a
// gradient.  No fast math: the logs and quotients stay exact.
#include <cuda_runtime.h>

#include "rounded.cuh"

namespace {

using namespace cnf::rn;

constexpr int kThreads = 128;
constexpr int kNodes = 15;
constexpr int kChunk = 32;  // lanes a warp takes from the counter at once
constexpr unsigned kFullMask = 0xffffffffu;

// the lanes taken so far of each entry's launch: [infprob][f64]; a
// launch of one entry and type runs alone on its device (the port
// launches on one stream)
__device__ unsigned long long g_taken[2][2];

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
// count), its terms in the twin's order; the products of y, g and h alone
// are formed once a lane, each rounded as the twin rounds it.
template <typename T>
struct PseudoLikelihood {
  T g, yg, yh, yg2, yh2, yygh, ygg, ygh, y2gh, gg;

  __device__ __forceinline__ T operator()(T x) const {
    const T lx = ln(x);
    const T l1x = ln(sub(T(1), x));
    T s = add(mul(-yg2, lx), mul(yg2, l1x));
    s = add(s, mul(yygh, lx));
    s = sub(s, mul(yygh, l1x));
    s = sub(s, yygh);
    s = sub(s, mul(yh2, x));
    s = add(s, yh2);
    s = add(s, mul(ygg, lx));
    s = sub(s, mul(ygg, l1x));
    s = add(s, ygg);
    s = add(s, mul(y2gh, x));
    s = sub(s, mul(ygh, lx));
    s = add(s, mul(ygh, l1x));
    s = sub(s, ygh);
    s = sub(s, mul(gg, x));
    T u = add(yg, mul(yh, x));
    u = sub(u, yh);
    u = sub(u, mul(g, x));
    return div(-s, mul(u, u));
  }
};

template <typename T>
__device__ __forceinline__ PseudoLikelihood<T> pseudo_likelihood(T y, T g,
                                                                 T h) {
  const T yg = mul(y, g), yh = mul(y, h);
  return {g,
          yg,
          yh,
          mul(yg, yg),
          mul(yh, yh),
          mul(mul(mul(y, y), g), h),
          mul(yg, g),
          mul(yg, h),
          mul(mul(mul(T(2), y), g), h),
          mul(g, g)};
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
  PseudoLikelihood<T> base;
  T ent, rel, desc;
  __device__ __forceinline__ T operator()(T x) const {
    const T e = mul(ent, log_odds_inv(x));
    const T r = mul(div(sub(rel, x), sub(x, mul(x, x))), desc);
    return add(add(base(x), e), r);
  }
};

// update_infprobs' gradient: base + ef * (log(1 / x - 1) + prior)
template <typename T>
struct InfprobGrad {
  PseudoLikelihood<T> base;
  T prior, ef;
  __device__ __forceinline__ T operator()(T x) const {
    return add(base(x), mul(add(log_odds_inv(x), prior), ef));
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

// capped.cappedgd for one lane, between its steps
template <typename T, typename Grad>
struct Bisection {
  Grad grad;
  T orig, eps, eps_hi, lolim, hilim, origc, lo, hi;
  bool brk, lowside;
  int it;

  __device__ __forceinline__ T clip(T v) const {
    return minimum(maximum(v, eps), eps_hi);
  }

  // the bounds and the starting bracket; false if the lane is dead (its
  // result is then final)
  __device__ __forceinline__ bool start(const Step<T>& st) {
    eps_hi = sub(T(1), eps);
    lolim = caplogitchange(eps, orig, eps, brk).value;
    hilim = caplogitchange(eps_hi, orig, eps, brk).value;
    const T lo0 = sub(lolim, mul(eps, T(0.125)));
    const T hi0 = add(hilim, mul(eps, T(0.125)));
    origc = caplogitchange(orig, orig, eps, brk).value;
    if (st.frozen) {  // every lane dead: the result needs no gradient
      lo = hi = origc;
      return false;
    }
    const T g0 = div(T(1), grad(clip(origc)));
    const bool dead = !isfinite(g0) || fabs(g0) > st.flat_limit;
    lowside = g0 < T(0);
    lo = (dead || !lowside) ? origc : lo0;
    hi = (dead || lowside) ? origc : hi0;
    it = 0;
    return !dead && st.iters > 0;
  }

  // one bisection step; true once the lane is done or out of steps
  __device__ __forceinline__ bool step(const Step<T>& st) {
    bool done = (lo > hilim) || (hi < lolim);
    const T mid = mul(T(0.5), add(lo, hi));
    const T start = minimum(origc, mid);
    const T end = maximum(origc, mid);
    const T qmid = mul(T(0.5), add(start, end));
    const T qhalf = mul(T(0.5), sub(end, start));
    // evaluation 0 at the bisection point, 1-15 at the quadrature nodes
    T gv = T(0), acc = T(0);
#pragma unroll 2
    for (int k = 0; k <= kNodes; ++k) {
      const int n = k > 0 ? k - 1 : 0;
      const T x = k == 0 ? mid : add(qmid, mul(qhalf, T(kGlX[n])));
      const T r = div(T(1), grad(clip(x)));
      if (k == 0)
        gv = r;
      else
        acc = add(acc, mul(r, T(kGlW[n])));
    }
    const bool bad = ((gv < T(0)) != lowside) || !isfinite(gv);
    done = done || (sub(end, start) < T(1e-10) && !bad);
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
    return done || ++it >= st.iters;
  }

  __device__ __forceinline__ Capped<T> result() const {
    return caplogitchange(mul(T(0.5), add(lo, hi)), orig, eps, brk);
  }
};

// The lanes of one launch, shared by its persistent grid: each warp takes
// kChunk lanes at a time from the launch's counter (zeroed on its stream
// before the launch) and hands them to its threads in lane order, one
// step at a time: a thread whose lane is done (or dead, or skipped) takes
// the warp's next lane before the following step.  ``lanes.open(i, b)``
// loads lane i into b and returns whether it needs a step (else it has
// written the lane itself), ``lanes.store(i, c)`` writes a result.
template <typename T, typename Lanes>
__device__ __forceinline__ void walk_lanes(const Lanes& lanes, int L,
                                           const Step<T>& st,
                                           unsigned long long* counter) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // the warp's chunk [next, end), the same in every lane
  unsigned long long next = 0, end = 0;
  bool dry = false;  // the launch's lanes are all taken
  Bisection<T, typename Lanes::Grad> b;
  bool live = false;
  int i = 0;
  for (;;) {
    for (;;) {
      const unsigned need = __ballot_sync(kFullMask, !live);
      if (need == 0) break;
      if (next >= end) {
        if (dry) break;
        unsigned long long base = 0;
        if (lane == 0) base = atomicAdd(counter, (unsigned long long)kChunk);
        base = __shfl_sync(kFullMask, base, 0);
        if (base >= (unsigned long long)L) {
          dry = true;
          break;
        }
        next = base;
        end = base + kChunk < (unsigned long long)L ? base + kChunk : L;
      }
      if (!live) {
        const unsigned long long k = next + __popc(need & below);
        if (k < end) {
          i = (int)k;
          live = lanes.open(i, b, st);
        }
      }
      next += __popc(need);
    }
    if (__ballot_sync(kFullMask, live) == 0) return;
    if (live && b.step(st)) {
      lanes.store(i, b.result());
      live = false;
    }
  }
}

// lanes [L], row r = lane / per_row: w, B, C, sim, rel, brk per lane,
// desc and eps per row
template <typename T>
struct HaploLanes {
  using Grad = HaploGrad<T>;
  const T *w, *B, *C, *sim, *rel, *desc, *eps;
  const unsigned char* brk;
  T* out;
  unsigned char* hit;
  int per_row;
  T ef;

  __device__ __forceinline__ bool open(int i, Bisection<T, Grad>& b,
                                       const Step<T>& st) const {
    const int r = i / per_row;
    b.grad = {pseudo_likelihood(w[i], B[i], C[i]), mul(sub(T(1), sim[i]), ef),
              rel[i], desc[r]};
    b.orig = w[i];
    b.eps = eps[r];
    b.brk = brk[i] != 0;
    if (b.start(st)) return true;
    store(i, b.result());
    return false;
  }
  __device__ __forceinline__ void store(int i, Capped<T> c) const {
    out[i] = c.value;
    hit[i] = c.hit;
  }
};

// lanes [L] of [N, M, 2, 2] (candidate allele minor), row r = lane /
// per_row: cp, a, prior per lane, t per (lane / 2), eps per row; a lane
// whose mass a is not above 0 is written as 0, no hit
template <typename T>
struct InfprobLanes {
  using Grad = InfprobGrad<T>;
  const T *cp, *a, *t, *prior, *eps;
  T* out;
  unsigned char* hit;
  int per_row;
  T ef;

  __device__ __forceinline__ bool open(int i, Bisection<T, Grad>& b,
                                       const Step<T>& st) const {
    const T g = a[i];
    if (!(g > T(0))) {
      store(i, {T(0), false});
      return false;
    }
    b.grad = {pseudo_likelihood(cp[i], g, t[i >> 1]), prior[i], ef};
    b.orig = cp[i];
    b.eps = eps[i / per_row];
    b.brk = false;
    if (b.start(st)) return true;
    store(i, b.result());
    return false;
  }
  __device__ __forceinline__ void store(int i, Capped<T> c) const {
    out[i] = c.value;
    hit[i] = c.hit;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    capped_haplo_kernel(HaploLanes<T> lanes, int L, Step<T> st,
                        unsigned long long* counter) {
  walk_lanes(lanes, L, st, counter);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    capped_infprob_kernel(InfprobLanes<T> lanes, int L, Step<T> st,
                          unsigned long long* counter) {
  walk_lanes(lanes, L, st, counter);
}

// the counter of an entry's launch, zeroed on the launch's stream
template <typename T>
cudaError_t zeroed_counter(int infprob, void* stream,
                           unsigned long long** counter) {
  void* base = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&base, g_taken);
  if (err != cudaSuccess) return err;
  *counter = static_cast<unsigned long long*>(base) + infprob * 2 +
             (sizeof(T) == 8 ? 1 : 0);
  return cudaMemsetAsync(*counter, 0, sizeof(unsigned long long),
                         (cudaStream_t)stream);
}

// blocks of the persistent grid for L lanes: as many as the card holds at
// once (the SMs times the kernel's resident blocks an SM, queried once a
// device), fewer if the lanes fill fewer (a lane a thread)
template <typename K>
cudaError_t grid_for(K kernel, int L, int* grid) {
  constexpr int kDevices = 64;
  static int resident[kDevices];  // 0: not queried yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int full = dev < kDevices ? resident[dev] : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    full = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kDevices) resident[dev] = full;
  }
  const long long need = ((long long)L + kThreads - 1) / kThreads;
  *grid = (int)(need < full ? need : full);
  return cudaSuccess;
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
  int grid = 0;
  unsigned long long* counter = nullptr;
  cudaError_t err = grid_for(capped_haplo_kernel<T>, L, &grid);
  if (err == cudaSuccess) err = zeroed_counter<T>(0, stream, &counter);
  if (err != cudaSuccess) return (int)err;
  capped_haplo_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      HaploLanes<T>{w, B, C, sim, rel, desc, eps, brk, out, hit, per_row,
                    ef},
      L, make_step(sf, tol, subst, flat_limit, frozen, iters), counter);
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
  int grid = 0;
  unsigned long long* counter = nullptr;
  cudaError_t err = grid_for(capped_infprob_kernel<T>, L, &grid);
  if (err == cudaSuccess) err = zeroed_counter<T>(1, stream, &counter);
  if (err != cudaSuccess) return (int)err;
  capped_infprob_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      InfprobLanes<T>{cp, a, t, prior, eps, out, hit, per_row, ef}, L,
      make_step(sf, tol, subst, flat_limit, frozen, iters), counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the threads of an entry's launch over L lanes (infprob: 0 for the
// haploweight entry, 1 for the genotype one; f64: 0 or 1), which share
// its lanes; a cudaError_t
int cnf_capped_threads(int infprob, int f64, int L, int* threads) {
  int grid = 0;
  const cudaError_t err =
      infprob ? (f64 ? grid_for(capped_infprob_kernel<double>, L, &grid)
                     : grid_for(capped_infprob_kernel<float>, L, &grid))
              : (f64 ? grid_for(capped_haplo_kernel<double>, L, &grid)
                     : grid_for(capped_haplo_kernel<float>, L, &grid));
  *threads = grid * kThreads;
  return (int)err;
}

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
