// Native core of the phase-flip optimiser (updates/phaseflip.py).
//
// The reference ships this combinatorial step to an external toulbar2
// MaxSAT subprocess (cnF2freq.cpp:6074-6098); our framework solves it
// in-process: exact enumeration over small connected components of
// families sharing members, iterated conditional modes over large ones.
// The Python reference implementation lives in
// updates/phaseflip.py::solve_marker; this file is the same algorithm in
// C++ for host-side speed on big cohorts.  Compiled on demand by
// cnf2freq_tpu_torch/native/__init__.py (g++ -O3 -shared), bound via
// ctypes.  The port's copy of cnf2freq_tpu/native/flipsolve.cc.
//
// ABI: one call per connected component.
//   n_vars   - number of flip variables in the component (<= 63 for the
//              exhaustive path; ICM has no limit)
//   n_fams   - number of families
//   fam_nv   - [n_fams]   variable count per family (<= 16)
//   vpos     - [sum nv]   flattened variable indices per family
//   scores   - [sum 2^nv] flattened per-pattern score tables; family i's
//              table starts at s_off[i]; -inf marks infeasible patterns
//   s_off    - [n_fams]   offsets into scores
//   exhaustive_limit, icm_restarts, icm_iters, seed - search knobs
//   out_mask - best assignment as a bitmask over component variables
// Returns the best score found.

#include <cstdint>
#include <cmath>
#include <limits>
#include <vector>

namespace {

inline int pattern_of(const int32_t* vp, int nv, uint64_t mask) {
  int p = 0;
  for (int k = 0; k < nv; k++) p |= (int)((mask >> vp[k]) & 1u) << k;
  return p;
}

// xorshift64* - deterministic, seedable, dependency-free
inline uint64_t rng_next(uint64_t& s) {
  s ^= s >> 12; s ^= s << 25; s ^= s >> 27;
  return s * 0x2545F4914F6CDD1DULL;
}

}  // namespace

extern "C" double flip_solve_component(
    int32_t n_vars, int32_t n_fams,
    const int32_t* fam_nv, const int32_t* vpos,
    const int64_t* s_off, const double* scores,
    int32_t exhaustive_limit, int32_t icm_restarts, int32_t icm_iters,
    uint64_t seed, uint64_t* out_mask) {
  const double NEG = -std::numeric_limits<double>::infinity();
  std::vector<const int32_t*> fvp(n_fams);
  {
    const int32_t* p = vpos;
    for (int f = 0; f < n_fams; f++) { fvp[f] = p; p += fam_nv[f]; }
  }
  auto total_score = [&](uint64_t mask) -> double {
    double sc = 0.0;
    for (int f = 0; f < n_fams; f++)
      sc += scores[s_off[f] + pattern_of(fvp[f], fam_nv[f], mask)];
    return sc;
  };

  if (n_vars <= exhaustive_limit) {
    uint64_t best_mask = 0;
    double best = NEG;
    const uint64_t end = 1ULL << n_vars;
    for (uint64_t a = 0; a < end; a++) {
      double sc = total_score(a);
      if (sc > best) { best = sc; best_mask = a; }
    }
    *out_mask = best_mask;
    return best;
  }

  // ICM: coordinate ascent with a var -> families index
  std::vector<std::vector<int32_t>> byvar(n_vars);
  for (int f = 0; f < n_fams; f++)
    for (int k = 0; k < fam_nv[f]; k++) {
      int v = fvp[f][k];
      if (byvar[v].empty() || byvar[v].back() != f) byvar[v].push_back(f);
    }

  uint64_t state = seed ? seed : 0x9E3779B97F4A7C15ULL;
  uint64_t best_mask = 0;
  double best = NEG;
  for (int r = 0; r < icm_restarts; r++) {
    uint64_t mask = 0;
    if (r > 0)
      for (int v = 0; v < n_vars; v++)
        if ((rng_next(state) >> 40) % 10 < 3) mask |= 1ULL << v;
    for (int it = 0; it < icm_iters; it++) {
      bool changed = false;
      for (int v = 0; v < n_vars; v++) {
        double sc[2] = {0.0, 0.0};
        for (int flip = 0; flip < 2; flip++) {
          uint64_t m2 = flip ? (mask | (1ULL << v))
                             : (mask & ~(1ULL << v));
          for (int32_t f : byvar[v])
            sc[flip] += scores[s_off[f] +
                               pattern_of(fvp[f], fam_nv[f], m2)];
        }
        bool want = sc[1] > sc[0];
        bool have = (mask >> v) & 1;
        if (want != have) { changed = true; mask ^= 1ULL << v; }
      }
      if (!changed) break;
    }
    double sc = total_score(mask);
    if (sc > best) { best = sc; best_mask = mask; }
  }
  *out_mask = best_mask;
  return best;
}

// v2: assignment returned as a byte vector — no 64-variable limit, so
// whole connected components of large cohorts (shared founders chain
// thousands of families together) solve natively.  Exhaustive search
// still runs for small components; otherwise ICM over the byte vector.
// If every restart lands on -inf (mutually infeasible patterns), the
// all-false assignment is returned: "flip nothing" is always feasible.

namespace {

inline int pattern_of_vec(const int32_t* vp, int nv, const uint8_t* vec) {
  int p = 0;
  for (int k = 0; k < nv; k++) p |= (int)(vec[vp[k]] & 1) << k;
  return p;
}

}  // namespace

extern "C" double flip_solve_component_v2(
    int32_t n_vars, int32_t n_fams,
    const int32_t* fam_nv, const int32_t* vpos,
    const int64_t* s_off, const double* scores,
    int32_t exhaustive_limit, int32_t icm_restarts, int32_t icm_iters,
    uint64_t seed, uint8_t* out_vec) {
  const double NEG = -std::numeric_limits<double>::infinity();
  std::vector<const int32_t*> fvp(n_fams);
  {
    const int32_t* p = vpos;
    for (int f = 0; f < n_fams; f++) { fvp[f] = p; p += fam_nv[f]; }
  }

  if (n_vars <= exhaustive_limit && n_vars <= 63) {
    uint64_t best_mask = 0;
    double best = NEG;
    const uint64_t end = 1ULL << n_vars;
    for (uint64_t a = 0; a < end; a++) {
      double sc = 0.0;
      for (int f = 0; f < n_fams; f++)
        sc += scores[s_off[f] + pattern_of(fvp[f], fam_nv[f], a)];
      if (sc > best) { best = sc; best_mask = a; }
    }
    if (!(best > NEG)) best_mask = 0;
    for (int v = 0; v < n_vars; v++) out_vec[v] = (best_mask >> v) & 1;
    return best;
  }

  std::vector<std::vector<int32_t>> byvar(n_vars);
  for (int f = 0; f < n_fams; f++)
    for (int k = 0; k < fam_nv[f]; k++) {
      int v = fvp[f][k];
      if (byvar[v].empty() || byvar[v].back() != f) byvar[v].push_back(f);
    }

  auto total_score_vec = [&](const std::vector<uint8_t>& vec) -> double {
    double sc = 0.0;
    for (int f = 0; f < n_fams; f++)
      sc += scores[s_off[f] + pattern_of_vec(fvp[f], fam_nv[f],
                                             vec.data())];
    return sc;
  };

  uint64_t state = seed ? seed : 0x9E3779B97F4A7C15ULL;
  std::vector<uint8_t> vec(n_vars), best_vec(n_vars, 0);
  double best = NEG;
  for (int r = 0; r < icm_restarts; r++) {
    for (int v = 0; v < n_vars; v++)
      vec[v] = (r > 0 && (rng_next(state) >> 40) % 10 < 3) ? 1 : 0;
    for (int it = 0; it < icm_iters; it++) {
      bool changed = false;
      for (int v = 0; v < n_vars; v++) {
        const uint8_t have = vec[v];
        double sc[2] = {0.0, 0.0};
        for (int flip = 0; flip < 2; flip++) {
          vec[v] = (uint8_t)flip;
          for (int32_t f : byvar[v])
            sc[flip] += scores[s_off[f] +
                               pattern_of_vec(fvp[f], fam_nv[f],
                                              vec.data())];
        }
        const uint8_t want = sc[1] > sc[0] ? 1 : 0;
        if (want != have) changed = true;
        vec[v] = want;
      }
      if (!changed) break;
    }
    double sc = total_score_vec(vec);
    if (sc > best) { best = sc; best_vec = vec; }
  }
  for (int v = 0; v < n_vars; v++) out_vec[v] = best_vec[v];
  return best;
}
