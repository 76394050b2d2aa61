"""Legacy negshift phase-flip path (the reference's ``DOTOULBAR=0`` mode).

Instead of the joint per-marker MaxSAT solve (updates/phaseflip.py), the
legacy mode scores *single-member* tail inversions only
(``c > 1 continue``, cnF2freq.cpp:5696-5697): per individual and marker a
``negshift`` log-likelihood-gain accumulator is filled from the turn
probes (``updatenegshifts``, cnF2freq.cpp:3640-3715), the most negative
position per (individual, chromosome) becomes an inversion candidate,
relatedness conflicts keep only the best candidate per family cluster
(``inferiorrelated``, cnF2freq.cpp:3415-3435, selection loop
cnF2freq.cpp:6269-6325), and winners flip their haploweight tail
(``negshifter``, cnF2freq.cpp:3437-3460 == updates.phaseflip.apply_flips).

Differences from the reference, by design:
* the reference gates candidate insertion on ``rand()/(RAND_MAX/5)``
  (cnF2freq.cpp:6317) — an ~80% acceptance coin flip; this port is
  deterministic (always accept), keeping iteration results reproducible.
* accumulation is vectorised over markers; per-turn values arrive as the
  already-computed turn score tensor instead of re-running sweeps.

Carried from ``cnf2freq_tpu/updates/negshift.py`` (numpy on the host;
the port imports nothing of the JAX package) with one rule of the port's
own: negshift sums equal up to ``NEGSHIFT_TIE_RTOL`` are ties, resolved
to the first marker (``select_candidates``), so that the inversion point
does not hang on the summation order, which differs between the card and
the CPU.  The JAX package takes the exact argmin.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..pedigree import Pedigree
from .phaseflip import FlipCandidate

# log of the clamp floor applied to summed turn likelihood ratios
# (cnF2freq.cpp:3657: val < 1e-174 -> 1e-174)
_LOG_CLAMP = math.log(1e-174)
# relative width (of the larger of |min| and 1) within which negshift sums
# tie: far above their rounding residue (~1e-14), far below a real gain
NEGSHIFT_TIE_RTOL = 1e-9


def tied_argmin(seg: np.ndarray) -> int:
    """The first position whose value ties the minimum (see
    NEGSHIFT_TIE_RTOL)."""
    low = seg.min()
    return int(np.argmax(seg <= low + max(abs(low), 1.0) * NEGSHIFT_TIE_RTOL))


def slot_turn_bits(cfg: ModelConfig) -> List[int]:
    """Turn-mask bit for each family slot, in slot order
    (updatenegshifts' hardcoded NUMGEN==3 layout, cnF2freq.cpp:3663-3687):
    focal = bit typebits; parent k = bit 3k; grandparent (k, j) =
    bit 3k + 1 + j."""
    assert cfg.numgen == 3
    bits = [cfg.typebits]
    for k in range(2):
        bits.append(3 * k)
        for j in range(2):
            bits.append(3 * k + 1 + j)
    return bits


def accumulate_negshift(ped: Pedigree, dous: List[int], lo: int, hi: int,
                        weights: np.ndarray, cfg: ModelConfig):
    """updatenegshifts (cnF2freq.cpp:3640-3715) over all analysis units.

    weights: [B, M, T] per-turn log likelihood-ratio sums over allowed
    shifts, *unscaled* (no descendant factor) — ``log val`` with
    ``val = sum_s exp(loglik(turn) - total)``; the no-turn entry is 0.
    Adds into each family member's ``ind.negshift[lo:hi]``:
    ``+log(val_0) - log(val_flip(member))`` with the 1e-174 clamp, and
    grandparent terms scaled by 1/parent.children.
    """
    bits = slot_turn_bits(cfg)
    Mi = hi - lo
    for b, n in enumerate(dous):
        ind = ped.by_id(n)
        slots = ped.family_slots(n)
        _shiftignore, flag2ignore = ped.fixtrees(n)
        # turn validity: g & (flag2ignore >> 1) must be 0
        # (cnF2freq.cpp:5688)
        valid = ~((np.asarray([1 << bit for bit in bits])
                   & (flag2ignore >> 1)) > 0)
        for s, (sid, bit) in enumerate(zip(slots, bits)):
            if sid <= 0 or not valid[s]:
                continue
            member = ped.by_id(sid)
            if member.negshift is None:
                continue
            # grandparent slots scale by the in-between parent's children
            # count (cnF2freq.cpp:3677-3687); slots 2,3 belong to parent
            # slot 1, slots 5,6 to slot 4
            scale = 1.0
            if s in (2, 3, 5, 6):
                if ind.gen < 2:
                    continue
                par = ped.by_id(slots[1 if s in (2, 3) else 4])
                scale = 1.0 / max(par.children, 1)
            logval = np.maximum(weights[b, :Mi, 1 << bit], _LOG_CLAMP)
            member.negshift[lo:hi] += -logval * scale


def select_candidates(ped: Pedigree, lo: int, hi: int,
                      threshold: float = -1e-10
                      ) -> List[Tuple[int, float, int]]:
    """Per-individual best inversion position + relatedness pruning
    (cnF2freq.cpp:6269-6325).  Returns surviving (ind id, val, marker)."""
    cands: List[Tuple[int, float, int]] = []
    for ind in ped.inds[1:]:
        if ind.negshift is None or ind.haploweight is None:
            continue
        seg = ind.negshift[lo:hi]
        p = tied_argmin(seg)
        val = float(seg[p])
        if val >= threshold or lo + p + 1 >= hi:
            continue
        ours = (ind.n, val, lo + p)
        inferior = False
        keep: List[Tuple[int, float, int]] = []
        for other in cands:
            if ped.arerelated(other[0], ind.n):
                if other[1] > val:
                    continue        # drop the worse relative
                inferior = True
            keep.append(other)
        cands = keep
        if not inferior:
            cands.append(ours)
    return cands


# Parent-pair swap moves (``parentswapnegshifts``, cnF2freq.cpp:5004-5084).
#
# Reference status at HEAD: this is *dead code twice over* — the call is
# compiled out under DOTOULBAR=1 (cnF2freq.cpp:6369-6371), and the nsm
# score map is only ever filled inside an ``#if false`` block written for
# a NUMGEN==2 bit layout (cnF2freq.cpp:3689-3712), so even the
# DOTOULBAR=0 build runs it on an empty map.  We port the *semantics*:
# per parent pair and marker, score four joint tail-flip hypotheses
# ("phase" codes k, mapped to turn masks of the live NUMGEN==3 layout):
#
#   k=1: flip parent 0          (turn bit 0)
#   k=2: flip parent 1          (turn bit 3)      <- the only code the
#                                                    reference enables
#   k=3: flip both parents      (bits 0|3)
#   k=4: parent swap, emulated by flipping every child that shares both
#        parents (the reference's ``phase & 4`` branch; the literal
#        data swap is disabled there with ``z == 0 && false``)
#
# and greedily apply the best positive-gain move per parent pair
# (``bestshift`` dominance, cnF2freq.cpp:5032-5037).  The reference's
# ~10% random acceptance gate (cnF2freq.cpp:5046) is dropped for
# determinism, consistently with this module's other documented
# determinism choices.

_PHASE_TURNS = {1: 1 << 0, 2: 1 << 3, 3: (1 << 0) | (1 << 3)}


def accumulate_pair_scores(ped: Pedigree, dous: List[int], lo: int,
                           hi: int, weights: np.ndarray, cfg: ModelConfig
                           ) -> Dict[Tuple[int, int], np.ndarray]:
    """nsm fill (cnF2freq.cpp:3698-3711, generalized to NUMGEN==3 turn
    bits): per (par0, par1) pair an [M, 5] array of summed log
    likelihood-ratio gains, one column per phase code 1..4 (column 0
    unused).  weights as in :func:`accumulate_negshift`."""
    Mi = hi - lo
    nsm: Dict[Tuple[int, int], np.ndarray] = {}
    focal_bit = cfg.typebits
    for b, n in enumerate(dous):
        ind = ped.by_id(n)
        if not (ind.pars[0] and ind.pars[1]):
            continue
        _shiftignore, flag2ignore = ped.fixtrees(n)
        key = (ind.pars[0], ind.pars[1])
        acc = nsm.get(key)
        if acc is None:
            acc = nsm[key] = np.zeros((Mi, 5))
        for k, turn in _PHASE_TURNS.items():
            if turn & (flag2ignore >> 1):
                continue
            acc[:, k] += np.maximum(weights[b, :Mi, turn], _LOG_CLAMP)
        # k=4: the swap hypothesis scores as the child's own flip
        if not ((1 << focal_bit) & (flag2ignore >> 1)):
            acc[:, 4] += np.maximum(weights[b, :Mi, 1 << focal_bit],
                                    _LOG_CLAMP)
    return nsm


def parent_swap_candidates(ped: Pedigree, dous: List[int], lo: int,
                           hi: int, weights: np.ndarray, cfg: ModelConfig,
                           phases: Tuple[int, ...] = (2,)
                           ) -> List[Tuple[float, int, int, int, int, int]]:
    """Scoring stage of parentswapnegshifts for one chromosome.

    Returns every (parent pair, marker, phase) hypothesis as
    ``(score, par0, par1, phase, marker, chrom_end)`` — the caller feeds
    candidates from *all* chromosomes into one
    :func:`apply_parent_swaps` pass, matching the reference's single
    genome-wide nsm map and single parentswapnegshifts call per pass
    (cnF2freq.cpp:5004-5084).  ``phases`` defaults to ``(2,)``, the only
    code enabled at reference HEAD (cnF2freq.cpp:5017-5018).
    """
    nsm = accumulate_pair_scores(ped, dous, lo, hi, weights, cfg)
    cands: List[Tuple[float, int, int, int, int, int]] = []
    for (p0, p1), acc in nsm.items():
        for k in phases:
            for m in range(hi - lo):
                # - 1e-5 tie-break margin (cnF2freq.cpp:5018)
                cands.append((acc[m, k] - 1e-5, p0, p1, k, lo + m, hi))
    return cands


def apply_parent_swaps(ped: Pedigree,
                       cands: List[Tuple[float, int, int, int, int, int]]
                       ) -> List[Tuple[int, int, int, int, float]]:
    """Genome-wide dominance + execution of parent-pair swap moves.

    Greedily accepts the best positive-gain move per parent pair across
    *all* candidate chromosomes (each accepted move raises both members'
    ``bestshift`` bar, so a parent takes at most one move genome-wide —
    the reference's dominance scope, cnF2freq.cpp:5032-5037) and applies
    the tail flips to ``haploweight`` directly — no haplobase
    bookkeeping, no lastinved update, exactly like the reference's
    emulated shifts (cnF2freq.cpp:5055-5082).
    Returns the applied moves as (par0, par1, phase, marker, score).
    """
    cands = sorted(cands, key=lambda t: (-t[0], t[1], t[2], t[3], t[4]))
    bestshift: Dict[int, float] = {}
    applied: List[Tuple[int, int, int, int, float]] = []
    for score, p0, p1, k, m, hi in cands:
        if score <= bestshift.get(p0, 0.0) or score <= bestshift.get(p1, 0.0):
            continue
        bestshift[p0] = score
        bestshift[p1] = score
        inds = (ped.by_id(p0), ped.by_id(p1))
        for z in (0, 1):
            if k & 4 and z == 1:
                # flip children that share both parents, once
                # (cnF2freq.cpp:5063-5071)
                for kid_n in ped._kids_of(p1):
                    kid = ped.by_id(kid_n)
                    if kid.pars[0] == p0 and kid.haploweight is not None:
                        kid.haploweight[m + 1:hi] = \
                            1.0 - kid.haploweight[m + 1:hi]
            if k & (1 << z) and inds[z].haploweight is not None:
                inds[z].haploweight[m + 1:hi] = \
                    1.0 - inds[z].haploweight[m + 1:hi]
        applied.append((p0, p1, k, m, score))
    return applied


def parent_swap_negshifts(ped: Pedigree, dous: List[int], lo: int, hi: int,
                          weights: np.ndarray, cfg: ModelConfig,
                          phases: Tuple[int, ...] = (2,)
                          ) -> List[Tuple[int, int, int, int, float]]:
    """parentswapnegshifts (cnF2freq.cpp:5004-5084) for one chromosome:
    score + genome-wide-style dominance + apply, in one call.  The
    production driver instead collects :func:`parent_swap_candidates`
    across chromosomes and runs :func:`apply_parent_swaps` once per
    iteration, after the parameter updates — the reference's call order
    (cnF2freq.cpp:6335-6371)."""
    return apply_parent_swaps(
        ped, parent_swap_candidates(ped, dous, lo, hi, weights, cfg,
                                    phases))


def negshift_flips(ped: Pedigree, dous: List[int], lo: int, hi: int,
                   weights: np.ndarray, cfg: ModelConfig
                   ) -> Optional[FlipCandidate]:
    """The full legacy pass for one chromosome: accumulate, select, and
    return the winning single-member inversions as a FlipCandidate
    (consumed by updates.phaseflip.apply_flips == negshifter)."""
    for ind in ped.inds[1:]:
        if ind.negshift is not None:
            ind.negshift[lo:hi] = 0.0
    accumulate_negshift(ped, dous, lo, hi, weights, cfg)
    cands = select_candidates(ped, lo, hi)
    if not cands:
        return None
    return FlipCandidate(
        score=-sum(v for _, v, _ in cands),
        cover={n for n, _, _ in cands},
        flips=[(n, m) for n, _, m in cands])
