"""Reference-exact phase-flip pipeline (parity mode).

A literal port of the reference's DOTOULBAR stage for one chromosome:
clause emission from the turn-likelihood tensor (cnF2freq.cpp:5759-5866),
the relskew clause reweighting (cnF2freq.cpp:5911-5963), the per-marker
weighted-MaxSAT solve with the dominance pre-check
(cnF2freq.cpp:5971-6096), candidate-clique extraction
(``computecandcliques``, cnF2freq.cpp:4880-4969), the bestcands dominance
set with ``mergebestcands`` (cnF2freq.cpp:5097-5183, 6119-6180), and the
winner's ``negshifter`` application contract (cnF2freq.cpp:3437-3460 via
updates.phaseflip.apply_flips).

The solver is a Python re-implementation of the WCNF stand-in shipped in
refbaseline/toulbar2.cc (the binary the compiled reference spawns):
exact enumeration per connected component up to MAXEXACT variables,
iterated conditional modes from the all-zero start above that — the same
optimum and the same tie-breaking (lowest assignment bits win).

Everything runs on integer clause weights (f64 weights truncated toward
zero at WEIGHT_DISCRETIZER=1e6, cnF2freq.cpp:44, 5850), so parity holds
whenever the f64 turn statistics agree to better than the discretizer
resolution.  Deliberately host-side scalar Python: this is the strict
parity path for validation cohorts, not the production flip optimizer
(updates/phaseflip.py + native/flipsolve.cc).

Carried from ``cnf2freq_tpu/updates/refflips.py`` line for line (the port
imports nothing of the JAX package); tests/test_torch_host.py holds the
copy to the original."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..pedigree import Pedigree
from .phaseflip import FlipCandidate

WEIGHT_DISCRETIZER = 1_000_000
MAXCANDCOUNT = 1000
MAXEXACT = 22


def _trunc(x: float) -> int:
    """C++ double -> long long conversion (truncation toward zero)."""
    return int(x) if math.isfinite(x) else 0


def fillcandsexists(ped: Pedigree, n: int) -> Tuple[List[int], List[bool]]:
    """cnF2freq.cpp:4753-4822: slot -> individual id for the clause
    literals; duplicate members (inbreeding) keep only their first slot.
    Slots: 0=par0, 1-2=par0's parents, 3=par1, 4-5=par1's parents,
    6=focal."""
    cands = [0] * 7
    exists = [False] * 7
    fam = set()
    ind = ped.by_id(n)
    cands[6] = n
    exists[6] = True
    fam.add(n)

    def add(slot, who):
        if who and who not in fam:
            fam.add(who)
            cands[slot] = who
            exists[slot] = True

    for k in range(2):
        p = ind.pars[k]
        if not p:
            continue
        add(3 * k, p)
        par = ped.by_id(p)
        add(3 * k + 1, par.pars[0])
        add(3 * k + 2, par.pars[1])
    return cands, exists


def _skewterm_focal(hw: np.ndarray, rh: np.ndarray, hb: np.ndarray,
                    hc: np.ndarray, m: int) -> float:
    """calcskewterms at reference HEAD (cnF2freq.cpp:4469-4531): only the
    focal member's term survives (the loop is capped at i < 1), and the
    relskew-HMM weight is overridden by the neighbour haploweight
    (``val = hwo``, cnF2freq.cpp:4502)."""

    def lg(x):
        if x > 0:
            return math.log(x)
        return -math.inf if x == 0 else math.nan

    skew = 0.0
    rhm = float(rh[m])
    for ix in (0, 1):
        w = float(hw[m + (1 - ix)])
        hwo = float(hw[m + ix])
        val = hwo
        now = (w * val * (lg(rhm) + lg(w) + lg(hwo))
               + (1 - w) * (1 - val) * (lg(rhm) + lg(1 - w) + lg(1 - hwo))
               + w * (1 - val) * (lg(1 - rhm) + lg(w) + lg(1 - hwo))
               + (1 - w) * val * (lg(1 - rhm) + lg(1 - w) + lg(hwo)))
        then = ((1 - w) * val * (lg(rhm) + lg(1 - w) + lg(hwo))
                + w * (1 - val) * (lg(rhm) + lg(w) + lg(1 - hwo))
                + (1 - w) * (1 - val) * (lg(1 - rhm) + lg(1 - w)
                                         + lg(1 - hwo))
                + w * val * (lg(1 - rhm) + lg(w) + lg(hwo)))
        skew -= then - now
        if hc[m + ix]:
            gonext = hb[m + ix] / hc[m + ix]
            skew += 25000.0 if (gonext - w) * (w - 0.5) < 0 else 0.0
    return skew


def _solve_wcnf(clauses: List[Tuple[int, List[int]]], nbvar: int
                ) -> List[int]:
    """refbaseline/toulbar2.cc: minimise total weight of violated clauses
    (violated = every literal false; +v false when assign=0, -v false
    when assign=1).  Exact per component <= MAXEXACT vars (ties -> lowest
    assignment bits), ICM from all-zero above."""
    # dedupe literals per clause (by |lit| then sign), drop tautologies
    cls = []
    for w, lits in clauses:
        ls = sorted(set(lits), key=lambda v: (abs(v), v))
        if any(ls[k] == -ls[k + 1] for k in range(len(ls) - 1)):
            continue
        if ls:
            cls.append((w, ls))

    parent: Dict[int, int] = {}

    def find(x):
        r = x
        while parent[r] != r:
            r = parent[r]
        while parent[x] != r:
            parent[x], x = r, parent[x]
        return r

    for _, lits in cls:
        for lit in lits:
            parent.setdefault(abs(lit), abs(lit))
    for _, lits in cls:
        r0 = find(abs(lits[0]))
        for lit in lits[1:]:
            parent[find(abs(lit))] = r0

    comp: Dict[int, List[int]] = {}
    for ci, (_, lits) in enumerate(cls):
        comp.setdefault(find(abs(lits[0])), []).append(ci)

    assign = [0] * (nbvar + 1)
    for root in sorted(comp):
        idxs = comp[root]
        vars_ = sorted({abs(lit) for ci in idxs for lit in cls[ci][1]})
        vidx = {v: k for k, v in enumerate(vars_)}
        if len(vars_) <= MAXEXACT:
            masks = []   # per clause: (violated-iff bits under vmask)
            for ci in idxs:
                w, lits = cls[ci]
                vmask = want = 0
                for lit in lits:
                    b = 1 << vidx[abs(lit)]
                    vmask |= b
                    if lit < 0:
                        want |= b
                masks.append((w, vmask, want))
            best, bestcost = 0, None
            for bits in range(1 << len(vars_)):
                cost = 0
                for w, vmask, want in masks:
                    if (bits & vmask) == want:
                        cost += w
                if bestcost is None or cost < bestcost:
                    best, bestcost = bits, cost
            for k, v in enumerate(vars_):
                assign[v] = (best >> k) & 1
        else:
            val = [0] * len(vars_)
            var2cl: List[List[Tuple[int, int]]] = [[] for _ in vars_]
            nfalse = []
            for w, (ci) in enumerate(idxs):
                _, lits = cls[ci]
                nf = 0
                for lit in lits:
                    k = vidx[abs(lit)]
                    if lit > 0:
                        nf += 1
                    var2cl[k].append((w, 1 if lit > 0 else -1))
                nfalse.append(nf)
            lens = [len(cls[ci][1]) for ci in idxs]
            wts = [cls[ci][0] for ci in idxs]

            def flip_delta(k):
                d = 0
                for w, sign in var2cl[k]:
                    was_false = (not val[k]) if sign > 0 else val[k]
                    nf_new = nfalse[w] + (-1 if was_false else 1)
                    if nfalse[w] == lens[w] and nf_new != lens[w]:
                        d -= wts[w]
                    if nfalse[w] != lens[w] and nf_new == lens[w]:
                        d += wts[w]
                return d

            improved = True
            while improved:
                improved = False
                for k in range(len(vars_)):
                    if flip_delta(k) < 0:
                        for w, sign in var2cl[k]:
                            was_false = (not val[k]) if sign > 0 else val[k]
                            nfalse[w] += -1 if was_false else 1
                        val[k] ^= 1
                        improved = True
            for k, v in enumerate(vars_):
                assign[v] = val[k]
    return assign


class _CandData:
    __slots__ = ("score", "cover", "cands")

    def __init__(self, score=0, cover=(), cands=()):
        self.score = score
        self.cover = set(cover)
        self.cands = list(cands)   # (ind_id, weight, marker)

    def key(self):
        return (self.score, tuple(sorted(self.cover)))


def _smartincludes(s1, s2) -> bool:
    return len(s1) >= len(s2) and s2 <= s1


def _computecandcliques(tf, toul_m, bias) -> List[_CandData]:
    """cnF2freq.cpp:4880-4969 on the cost-transformed clauses."""
    result: List[_CandData] = []
    for weight, lits in toul_m:
        viol = True
        anyswitch = False
        for v in lits:
            ind = abs(v)
            if v < 0:
                anyswitch = True
            if tf[ind - 1] == (1 if v > 0 else 0):
                viol = False
        if not (viol and anyswitch):
            continue
        useindex = -1
        i = 0
        while i < len(result):
            hit = any(abs(v) in result[i].cover for v in lits)
            if hit:
                if useindex == -1:
                    useindex = i
                else:
                    result[useindex].cover |= result[i].cover
                    result[useindex].cands.extend(result[i].cands)
                    result[useindex].score += result[i].score
                    del result[i]
                    continue
            i += 1
        if useindex == -1:
            result.append(_CandData())
            useindex = len(result) - 1
        r = result[useindex]
        r.score -= bias - weight
        for v in lits:
            ind = abs(v)
            if ind not in r.cover:
                r.cover.add(ind)
                if tf[ind - 1]:
                    r.cands.append((ind, weight, None))
    return result


def _mergebestcands(best: List[_CandData], ceiling: int, clearto: int):
    """cnF2freq.cpp:5097-5183.  ``best`` is kept sorted by key()."""
    while True:
        toolarge = False
        toremove = []
        delprev = False
        i = len(best) - 1
        while i >= 0 and not toolarge:
            if delprev:
                toremove.append(best[i + 1])
            delprev = False
            for j in range(len(best)):
                if not (best[j].key() < best[i].key()):
                    break
                a, b = best[i], best[j]
                inter = a.cover & b.cover
                covered = len(inter) > 0
                fullcover = a.cover == b.cover
                if not covered:
                    nc = _CandData(a.score + b.score, a.cover | b.cover,
                                   a.cands + b.cands)
                    best.append(nc)
                    best.sort(key=_CandData.key)
                    # re-find i after resort: restart the outer scan
                    # conservatively (the reference iterates a std::set,
                    # insertion keeps iterators valid; emulate by
                    # restarting from the tail)
                    i = len(best)
                    delprev = False
                    break
                if fullcover:
                    delprev = True
                    break
                if len(best) > ceiling:
                    break
            if len(best) > ceiling:
                toolarge = True
                break
            i -= 1
        for r in toremove:
            if r in best:
                best.remove(r)
        while len(best) > ceiling:
            best.pop()
        if not toolarge:
            break
    while len(best) > clearto:
        best.pop()


def reference_flips(ped: Pedigree, cfg: ModelConfig, dous: List[int],
                    lo: int, hi: int, W: np.ndarray,
                    haplobase: np.ndarray, haplocount: np.ndarray,
                    ind_index: Dict[int, int]) -> Optional[FlipCandidate]:
    """One chromosome's reference flip stage.  W: [B, Mc, numturns] f64
    descendants-scaled turn log-weights (probes.turn_weights_fast = the
    reference's ``computew``).  Returns the winner as a FlipCandidate
    (apply via updates.phaseflip.apply_flips = negshifter) or None."""
    Mc = hi - lo
    toul: List[List[Tuple[int, List[int]]]] = [[] for _ in range(Mc)]
    maxweight = 0

    for b, n in enumerate(dous):
        cands, exists = fillcandsexists(ped, n)
        f2mask = ped.fixtrees(n)[1] >> 1
        lits_cache = {}
        submax = 0
        for g in range(cfg.numturns):
            if g & f2mask:
                continue
            lits = lits_cache.get(g)
            if lits is None:
                lits = [(-cands[bb] if (g >> bb) & 1 else cands[bb])
                        for bb in range(7) if exists[bb]]
                lits_cache[g] = lits
            for mi in range(Mc):
                w = float(W[b, mi, g])
                if not math.isfinite(w):
                    w = -1000000.0 if w < 0 else 25000.0
                w = min(max(w, -1000000.0), 25000.0)
                weight = _trunc(w * WEIGHT_DISCRETIZER) - g
                if weight > submax:
                    submax = weight
                toul[mi].append((weight, lits))
        if submax > maxweight:
            maxweight = submax

        # relskew clause reweighting (cnF2freq.cpp:5911-5963)
        if cfg.relskews:
            ind = ped.by_id(n)
            i = ind_index[n]
            submax = 0
            hw = ind.haploweight
            rh = ind.relhaplo if ind.relhaplo is not None else \
                np.full_like(hw, 0.5)
            for mi in range(Mc - 1):
                m = lo + mi
                w = _skewterm_focal(hw, rh, haplobase[i], haplocount[i],
                                    m) * 0.5
                if not math.isfinite(w) or abs(w) > 25000:
                    w = -25000.0 if w < -25000 else 25000.0
                adj = w * ind.descendants * WEIGHT_DISCRETIZER
                row = toul[mi]
                for ci in range(len(row)):
                    weight, lits = row[ci]
                    if lits and lits[-1] == -n:
                        weight = _trunc(float(weight) - adj)
                        row[ci] = (weight, lits)
                        if weight > submax:
                            submax = weight
            if submax > maxweight:
                maxweight = submax

    # ---- per-marker solve stage (cnF2freq.cpp:5978-6166) -------------
    bestcands: List[_CandData] = []
    for mi in range(Mc - 1):
        row = toul[mi]
        # fakegain pre-check + cost transform (in one pass, as in the
        # reference)
        fakegain = 0
        fakegainterm = 0
        prevlast = None
        fakecover = set()
        new_row = []
        for weight, lits in row:
            mainind = abs(lits[-1]) if lits else 0
            if mainind != prevlast:
                fakegain += fakegainterm
                fakegainterm = 0
                prevlast = mainind
            if weight > fakegainterm:
                fakegainterm = weight
                fakecover.update(abs(v) for v in lits)
            new_row.append((maxweight - weight + 1, lits))
        fakegain += fakegainterm
        toul[mi] = new_row
        if not fakegain:
            continue
        fakegain = -fakegain
        skippable = bool(
            len(bestcands) >= MAXCANDCOUNT
            and bestcands[-1].score < fakegain)
        for elem in bestcands:
            if skippable:
                break
            if elem.score > fakegain:
                break
            if _smartincludes(fakecover, elem.cover):
                skippable = True
        if skippable:
            continue

        # _solve_wcnf returns assign[0..nbvar] (1-based vars);
        # computecandcliques consumes the reference's 0-based sol vector
        # (tf[ind - 1], cnF2freq.cpp:4895)
        tf = _solve_wcnf(new_row, nbvar=2000)[1:]
        for data in _computecandcliques(tf, new_row, maxweight + 1):
            if not (data.cover and data.score < 0):
                continue
            data.cands = [(ind, w, lo + mi) for ind, w, _ in data.cands]
            toremove = []
            addme = True
            for elem in bestcands:
                firstmatch = False
                if _smartincludes(elem.cover, data.cover):
                    if data.score <= elem.score:
                        toremove.append(elem)
                    firstmatch = True
                if _smartincludes(data.cover, elem.cover):
                    if elem.score <= data.score:
                        addme = False
                    if firstmatch:
                        break
            if addme:
                for r in toremove:
                    bestcands.remove(r)
                bestcands.append(data)
                bestcands.sort(key=_CandData.key)
            if len(bestcands) > MAXCANDCOUNT:
                _mergebestcands(bestcands, MAXCANDCOUNT * 2,
                                MAXCANDCOUNT // 2)

    _mergebestcands(bestcands, MAXCANDCOUNT, MAXCANDCOUNT)
    if not bestcands:
        return None
    winner = bestcands[0]
    # set semantics of negshiftcands: dedupe (ind, weight, marker)
    flips = sorted({(ind, w, m) for ind, w, m in winner.cands})
    return FlipCandidate(score=-float(winner.score) / WEIGHT_DISCRETIZER,
                         cover=set(winner.cover),
                         flips=[(ind, m) for ind, _, m in flips])
