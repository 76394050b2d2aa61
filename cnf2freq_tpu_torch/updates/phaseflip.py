"""Native phase-flip optimiser: device scoring plus host solve.

Port of ``cnf2freq_tpu/updates/phaseflip.py``.  Per chromosome, turn
weights are clamped, adjusted by the relskew clause terms, summed into
per-family flip-pattern scores and reduced to the top-k gainful markers
on the device (``make_flip_scorer``); the joint per-marker solve over
families sharing individuals runs on the host in the C++ core
(``native/flipsolve.cc``, the port's copy of the JAX package's).

The numpy solver side (``_components``, ``solve_component``,
``FlipCandidate``, ``extract_candidates``, ``select_winner``,
``apply_flips``, ``family_variables``) is carried over unchanged: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..pedigree import Pedigree
from .scatter import ordered_sums

WEIGHT_CLAMP_LO = -1_000_000.0
WEIGHT_CLAMP_HI = 25_000.0


def family_variables(ped: Pedigree, focal: int) -> Tuple[Tuple[int, ...],
                                                         Tuple[bool, ...]]:
    """Turn-bit -> individual mapping with first-occurrence dedup.  Bit
    order for numgen==3: parent0, gp00, gp01, parent1, gp10, gp11,
    focal."""
    cfg = ped.config
    slots = ped.family_slots(focal)
    if cfg.numgen == 3:
        order = [cfg.parent_slot(0), cfg.grandparent_slot(0, 0),
                 cfg.grandparent_slot(0, 1), cfg.parent_slot(1),
                 cfg.grandparent_slot(1, 0), cfg.grandparent_slot(1, 1)]
    else:
        order = [cfg.parent_slot(0), cfg.parent_slot(1)]
    nbits = cfg.turnbits
    seen = {focal}
    members = [0] * nbits
    exists = [False] * nbits
    members[nbits - 1] = focal
    exists[nbits - 1] = True
    for bit, slot in enumerate(order):
        sid = slots[slot]
        if sid and sid not in seen:
            seen.add(sid)
            members[bit] = sid
            exists[bit] = True
        elif sid:
            members[bit] = sid   # present but deduplicated
    return tuple(members), tuple(exists)


def _skew_terms(hw, rh, hb, hc, desc, M: int, halo: bool):
    """calcskewterms clause adjustment [B, M] (zero past the last real
    interval)."""
    B = hw.shape[0]
    dtype = hw.dtype
    Mi = M if halo else M - 1
    # the smallest normal number, not a subnormal: at an anchored marker
    # (haploweight exactly 0 or 1) the log guard meets a zero weight, and
    # 0 * log(guard) must stay 0 wherever subnormals are flushed (the JAX
    # package's 1e-323 flushes to 0 on XLA CPU and the TPU, making the
    # term NaN there)
    tiny = torch.finfo(dtype).tiny

    def slog(x):
        return torch.log(torch.clamp(x, min=tiny))

    skew = torch.zeros((B, Mi), dtype=dtype, device=hw.device)
    rhs = rh[:, :Mi]
    lrh, l1rh = slog(rhs), slog(1 - rhs)
    for ix in range(2):
        w_ = hw[:, 1 - ix:Mi + 1 - ix]
        wo = hw[:, ix:Mi + ix]
        lw, l1w = slog(w_), slog(1 - w_)
        lo_, l1o = slog(wo), slog(1 - wo)
        val = wo
        now = (w_ * val * (lrh + lw + lo_) +
               (1 - w_) * (1 - val) * (lrh + l1w + l1o) +
               w_ * (1 - val) * (l1rh + lw + l1o) +
               (1 - w_) * val * (l1rh + l1w + lo_))
        then = ((1 - w_) * val * (lrh + l1w + lo_) +
                w_ * (1 - val) * (lrh + lw + l1o) +
                (1 - w_) * (1 - val) * (l1rh + l1w + l1o) +
                w_ * val * (l1rh + lw + lo_))
        skew = skew - (then - now)
        hcx = hc[:, ix:Mi + ix]
        hbx = hb[:, ix:Mi + ix]
        gonext = torch.where(hcx > 0, hbx / torch.clamp(hcx, min=tiny), 0.0)
        skew = skew + torch.where(
            (hcx > 0) & ((gonext - w_) * (w_ - 0.5) < 0), 25000.0, 0.0)
    w = skew * 0.5
    w = torch.where(torch.isfinite(w), w, torch.sign(w) * 25000.0)
    w = torch.clamp(w, -25000.0, 25000.0) * desc[:, None]
    if Mi < M:
        w = torch.cat([w, torch.zeros((B, M - Mi), dtype=dtype,
                                      device=w.device)], dim=1)
    return w


def make_flip_scorer():
    """Device clause scoring: clamp + relskew adjustment + pattern sums +
    top-k marker selection; only [B, k] slices leave the device."""

    def score(parts, pat, allowed, hw, rh, hb, hc, desc, tsel, k: int,
              with_skew: bool, halo: bool = False):
        """parts: sequence of [Bi, M, T] turn-weight chunks; pat [B, T]
        per-family pattern index of each turn; allowed [B, T] bool;
        hw/rh/hb/hc [B, M] (or [B, M+1] with halo) skew inputs; desc [B];
        tsel [T] bool.  Returns (idx [k], mg [k], gains [B, k],
        S [B, k, P])."""
        W = parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=0)
        W = torch.clamp(torch.nan_to_num(W, nan=WEIGHT_CLAMP_LO,
                                         posinf=WEIGHT_CLAMP_HI,
                                         neginf=WEIGHT_CLAMP_LO),
                        WEIGHT_CLAMP_LO, WEIGHT_CLAMP_HI)
        B, M, T = W.shape
        if with_skew:
            w = _skew_terms(hw, rh, hb, hc, desc, M, halo)
            W = W - w[:, :, None] * tsel[None, None, :].to(W.dtype)
        # pattern sums: S[b, m, p] = sum_{t: pat[b,t]==p, allowed} W[b,m,t]
        # (a scatter-add, free of matrix-product rounding, in turn order)
        Wa = W * allowed[:, None, :].to(W.dtype)
        idx_t = pat.long()[:, None, :].expand(B, M, T)
        reach = torch.zeros((B, T), dtype=W.dtype, device=W.device)
        with ordered_sums():
            S = torch.zeros_like(W).scatter_add_(2, idx_t, Wa)
            reach.scatter_add_(1, pat.long(), allowed.to(W.dtype))
        S = torch.where(reach[:, None, :] > 0, S, -torch.inf)
        gains = S.max(dim=2).values - S[:, :, 0]             # [B, M]
        mg = torch.where(gains > 1e-12, gains, 0.0).sum(dim=0)
        mg_top, idx = torch.topk(mg, k)
        return idx, mg_top, gains[:, idx], S[:, idx]

    return score


def _components(fams: Sequence[Tuple[List[int], np.ndarray]]
                ) -> List[List[int]]:
    """Connected components of families sharing variables."""
    parent: Dict[int, int] = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for vars_, _ in fams:
        for v in vars_[1:]:
            union(vars_[0], v)
    groups: Dict[int, List[int]] = {}
    for fi, (vars_, _) in enumerate(fams):
        groups.setdefault(find(vars_[0]), []).append(fi)
    return list(groups.values())


def _solve_component_native(lib, fam_masks, n: int,
                            exhaustive_limit: int, icm_restarts: int
                            ) -> Optional[np.ndarray]:
    """One component through the C++ core (native/flipsolve.cc, v2 ABI).
    Returns a bool[n] assignment, or None when inputs exceed the ABI."""
    import ctypes
    fam_nv = np.array([len(pos) for pos, _ in fam_masks], dtype=np.int32)
    if (fam_nv > 16).any():
        return None
    vpos = np.concatenate([pos for pos, _ in fam_masks]).astype(np.int32) \
        if fam_masks else np.zeros(0, np.int32)
    scores = np.concatenate([np.ascontiguousarray(S, dtype=np.float64)
                             for _, S in fam_masks])
    lens = np.array([len(S) for _, S in fam_masks], dtype=np.int64)
    s_off = np.zeros(len(fam_masks), dtype=np.int64)
    if len(lens) > 1:
        s_off[1:] = np.cumsum(lens[:-1])
    out_vec = np.zeros(n, dtype=np.uint8)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.flip_solve_component_v2(
        np.int32(n), np.int32(len(fam_masks)),
        ptr(fam_nv, ctypes.c_int32), ptr(vpos, ctypes.c_int32),
        ptr(s_off, ctypes.c_int64), ptr(scores, ctypes.c_double),
        np.int32(exhaustive_limit), np.int32(icm_restarts), np.int32(12),
        ctypes.c_uint64(0x9E3779B97F4A7C15), ptr(out_vec, ctypes.c_uint8))
    return out_vec.astype(bool)


def solve_component(fam_masks, n: int, exhaustive_limit: int = 13,
                    icm_restarts: int = 2,
                    rng: Optional[np.random.Generator] = None,
                    lib=None) -> np.ndarray:
    """Best joint assignment for one connected component: the C++ core
    when a toolchain built it, else exhaustive search on small components
    and iterated conditional modes on large ones.  fam_masks: per family
    (component-local variable positions, score vector S[P])."""
    rng = rng or np.random.default_rng(0)
    if lib is not None:
        vec = _solve_component_native(
            lib, fam_masks, n, max(exhaustive_limit, 20), icm_restarts)
        if vec is not None:
            return vec
    if n <= exhaustive_limit:
        best_a, best_score = 0, -np.inf
        for a in range(1 << n):
            sc = 0.0
            for pos, S in fam_masks:
                p = 0
                for i, vp in enumerate(pos):
                    if (a >> vp) & 1:
                        p |= 1 << i
                sc += S[p]
            if sc > best_score:
                best_score, best_a = sc, a
        return np.array([(best_a >> i) & 1 for i in range(n)], dtype=bool)
    byvar = [[] for _ in range(n)]
    for fi2, (pos, S) in enumerate(fam_masks):
        for vp in set(pos.tolist()):
            byvar[vp].append(fi2)

    def fam_score(fi2, vec):
        pos, S = fam_masks[fi2]
        p = 0
        for k, vp in enumerate(pos):
            if vec[vp]:
                p |= 1 << k
        return S[p]

    # "flip nothing" is always feasible
    best_vec, best_score = np.zeros(n, dtype=bool), -np.inf
    for r in range(icm_restarts):
        vec = np.zeros(n, dtype=bool) if r == 0 else rng.random(n) < 0.3
        for _ in range(12):
            changed = False
            for i in range(n):
                have = bool(vec[i])
                sc = [0.0, 0.0]
                for flip in (False, True):
                    vec[i] = flip
                    for fi2 in byvar[i]:
                        sc[flip] += fam_score(fi2, vec)
                better = sc[1] > sc[0]
                if better != have:
                    changed = True
                vec[i] = better
            if not changed:
                break
        total = sum(fam_score(fi2, vec) for fi2 in range(len(fam_masks)))
        if total > best_score:
            best_score, best_vec = total, vec.copy()
    return best_vec


@dataclasses.dataclass
class FlipCandidate:
    score: float                       # total log-gain (positive = good)
    cover: Set[int]                    # individuals involved
    flips: List[Tuple[int, int]]       # (individual, marker) pairs


def extract_candidates(fams, assign: Dict[int, bool], marker: int
                       ) -> List[FlipCandidate]:
    """Group the marker solution into connected flip cliques and score
    each; only families with a flipped member contribute."""
    flipped = []
    for vars_, S in fams:
        p = 0
        for i, v in enumerate(vars_):
            if assign.get(v, False):
                p |= 1 << i
        if p:
            flipped.append((vars_, S, p))
    out: List[FlipCandidate] = []
    for comp in _components([(v, S) for v, S, _ in flipped]):
        score = 0.0
        cover: Set[int] = set()
        for fi in comp:
            vars_, S, p = flipped[fi]
            score += S[p]
            cover.update(vars_)
        flips = [(v, marker) for v in sorted(cover) if assign.get(v, False)]
        out.append(FlipCandidate(score=score, cover=cover, flips=flips))
    return out


def select_winner(cands: List[FlipCandidate],
                  min_gain: float = 1e-3) -> Optional[FlipCandidate]:
    """Combine disjoint-cover candidates and return the best combined
    candidate with positive gain."""
    cands = [c for c in cands if c.score > min_gain]
    if not cands:
        return None
    cands.sort(key=lambda c: -c.score)
    chosen: List[FlipCandidate] = []
    used: Set[int] = set()
    for c in cands:
        if used & c.cover:
            continue
        chosen.append(c)
        used |= c.cover
    return FlipCandidate(score=sum(c.score for c in chosen),
                         cover=set().union(*(c.cover for c in chosen)),
                         flips=[f for c in chosen for f in c.flips])


def apply_flips(ped: Pedigree, winner: FlipCandidate, chrom: int,
                haplobase=None, haplocount=None,
                ind_index: Optional[Dict[int, int]] = None):
    """negshifter: invert haplotype weights (and the accumulated
    statistics, numpy arrays or tensors) from the flip marker + 1 to the
    chromosome end."""
    lo, hi = ped.chromosome_range(chrom)
    for n, m in winner.flips:
        ind = ped.by_id(n)
        ind.lastinved[chrom] = m
        sl = slice(m + 1, hi)
        ind.haploweight[sl] = 1.0 - ind.haploweight[sl]
        if haplobase is not None and ind_index is not None \
                and n in ind_index:
            i = ind_index[n]
            haplobase[i, sl] = haplocount[i, sl] - haplobase[i, sl]
