"""Iteration driver: preprocessing and the outer EM-like loop.

Port of ``cnf2freq_tpu/driver.py`` on its non-resident, unmeshed,
unblocked, non-parity, native-flip branch: per chromosome and chunk of
analysis units, the scan and the segment-sum merges run on the device and
fold into per-individual accumulators that stay device tensors; the flip
scorer runs on the device, the component solve on the host (C++ core);
the capped-gradient updates run on the device and write the new
parameters back into the shared ``Pedigree``.

Adaptive relhaplo is on by default, as in the JAX package: the scan then
carries the adjacent-phase coherence of every slot (the classic
[B, M, NS, S] pipeline of ``engine.chromosome_scan``, computed in one pass
inside the scan as the JAX package's mesh route does), the coherence is
scattered onto per-individual sums, and relhaplo is refreshed from them
before the parameter updates.  ``adaptive_relhaplo=False`` runs the v2
pipeline with relhaplo inert, the reference binary's own behaviour.

The Driver runs on the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import (SEXMARKER, UNKNOWN, ZP_NO_EQUIVALENCE, ModelConfig,
                     RuntimeParams)
from .engine import scan_merged
from .hmm.emission import build_blocks
from .hmm.family import gather_family
from .hmm.transition import rate_matrix
from .ops.scan import R_QUANTUM
from .pedigree import Pedigree
from .updates.parameter_updates import update_haploweights, update_infprobs
from .updates.phaseflip import (FlipCandidate, _components, apply_flips,
                                extract_candidates, family_variables,
                                make_flip_scorer, select_winner,
                                solve_component)
from .updates.relskew import relskew_ratio
from .updates.scatter import scatter_coherence


def copy_pedigree(ped: Pedigree) -> Pedigree:
    """An independent deep copy (every per-individual array copied), so
    two drivers can start from identical state."""
    return copy.deepcopy(ped)


@dataclasses.dataclass
class DriverState:
    """Mutable cross-iteration knobs (the reference's globals)."""

    scalefactor: float = 0.013
    oldhitnnn: int = 0
    oldhitnnn2: int = 0
    iter: int = 0


# hot markers per chromosome that get a joint flip solve
MAX_FLIP_MARKERS = 16
# [M, 512] tensors per unit that a scan chunk holds: v2 pipeline (e, three
# sweep stores, statistics and turn temporaries); classic pipeline with
# coherence (e, three sweep stores, the turn transforms, one slot's
# coherence temporaries)
UNIT_TENSORS = {False: 8, True: 16}
# relhaplo stays inside (RELHAPLO_CLIP, 1 - RELHAPLO_CLIP)
RELHAPLO_CLIP = 1e-4
# phase-anchor choice: relative width of a variance tie, and the variance
# below which a marker counts as uninformative (the rounding residue of
# an exact zero is ~1e-28)
LOCK_TIE_RTOL = 1e-9
VARIANCE_FLOOR = 1e-20
# grid of the flip-pattern scores (log-likelihood units): far above their
# rounding residue (~1e-11 next to the +-25000 relskew clause terms), far
# below the 1e-3 gain a flip must reach
FLIP_SCORE_QUANTUM = 2.0 ** -14

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


def anchor_marker(variances: np.ndarray) -> Optional[int]:
    """Index of the phase anchor among a chromosome's remaining markers,
    or None.  So that the choice does not hang on the device's summation
    order: variances equal up to rounding are ties (symmetric families
    give many exact ties), resolved to the first marker, and variances at
    the rounding floor of an exact zero carry no information.  (The JAX
    package takes the exact argmax, and skips only when every variance is
    <= 0.)"""
    if variances.size == 0 or variances.max() <= VARIANCE_FLOOR:
        return None
    return int(np.argmax(variances >= variances.max() * (1 - LOCK_TIE_RTOL)))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype)]


class Driver:
    def __init__(self, ped: Pedigree, params: Optional[RuntimeParams] = None,
                 dtype=torch.float64, device="cuda",
                 adaptive_relhaplo: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        self.ped = ped
        self.cfg: ModelConfig = ped.config
        if self.cfg.numgen != 3 or not self.cfg.haplotyping \
                or self.cfg.selfing or self.cfg.relskewstates:
            raise NotImplementedError(
                "the port carries the default F2 haplotyping model only")
        self.params = params or RuntimeParams()
        self.state = DriverState(scalefactor=self.params.scalefactor)
        self.dtype = _torch_dtype(dtype)
        # measured adjacent-phase coherence feeding relhaplo
        self.adaptive_relhaplo = adaptive_relhaplo
        # units per scan chunk: "auto" sizes chunks to the device memory,
        # None scans the whole cohort at once, an int fixes the size
        self.batch_size = "auto"
        self._pair_tables: Dict[int, np.ndarray] = {}
        self._pair_pending: list = []
        self._cache: dict = {}

    def _t(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), device=self.device,
                               dtype=dtype or self.dtype)

    # ------------------------------------------------------------------
    def export_state(self) -> dict:
        st = self.state
        return dict(scalefactor=st.scalefactor, oldhitnnn=st.oldhitnnn,
                    oldhitnnn2=st.oldhitnnn2, iter=st.iter)

    def import_state(self, d: dict) -> None:
        """Take the cross-iteration knobs from an ``export_state`` dict of
        either package's Driver."""
        st = self.state
        st.scalefactor = float(d.get("scalefactor", st.scalefactor))
        st.oldhitnnn = int(d.get("oldhitnnn", st.oldhitnnn))
        st.oldhitnnn2 = int(d.get("oldhitnnn2", st.oldhitnnn2))
        st.iter = int(d.get("iter", st.iter))

    @property
    def pair_tables(self) -> Dict[int, np.ndarray]:
        """Ordered-genotype posterior tables {focal id: [M, 2, 2]}; device
        tables are copied out on first read."""
        for ids, lo, pair_dev in self._pair_pending:
            pair = pair_dev.to("cpu", torch.float64).numpy()
            for b, n in enumerate(ids):
                tab = self._pair_tables.setdefault(
                    n, np.zeros((self.ped.num_markers, 2, 2)))
                tab[lo:lo + pair.shape[1]] = pair[b]
        self._pair_pending.clear()
        return self._pair_tables

    def _chunk_size(self, n_units: int, m_markers: int,
                    with_coherence: bool = False) -> int:
        """Units per scan chunk.  "auto" on the card: half the free device
        memory over the [M, 512] tensors a unit holds in the scan
        (``UNIT_TENSORS``), in whole warps of units; on the CPU the whole
        cohort."""
        if self.batch_size is None:
            return n_units
        if self.batch_size != "auto":
            return int(self.batch_size)
        if self.device.type != "cuda":
            return n_units
        free, _ = torch.cuda.mem_get_info(self.device)
        itemsize = torch.finfo(self.dtype).bits // 8
        per_unit = UNIT_TENSORS[with_coherence] * m_markers * 512 * itemsize
        bs = int(0.5 * free // per_unit)
        if bs >= n_units:
            return n_units
        return max(R_QUANTUM, bs // R_QUANTUM * R_QUANTUM)

    # ------------------------------------------------------------------
    # Preprocessing (postmarkerdata)
    # ------------------------------------------------------------------
    def preprocess(self):
        ped = self.ped
        self._correction_inference_loop()
        ped.count_descendants()
        for ind in ped.inds[1:]:
            ped.fixtrees(ind.n)       # sets founder flags
        self._compute_variances()
        for ind in ped.inds[1:]:
            if ind.haploweight is not None:
                for c in range(ped.num_chromosomes):
                    self._lockhaplos(ind, c)

    def _correction_inference_loop(self):
        ped = self.ped
        while True:
            ped.count_children(dous_only=False)
            for ind in ped.inds[1:]:
                self._fixkid(ind)
            ped.count_descendants(reset=True)
            if not self._fixparents_round():
                break

    def _fixkid(self, ind):
        """Fill a fully-missing genotype from homozygous parents."""
        ped = self.ped
        md, ms = ind.markerdata, ind.markersure
        both_unknown = (md[:, 0] == UNKNOWN) & (md[:, 1] == UNKNOWN)
        for p in range(2):
            par = ped.by_id(ind.pars[p]) if ind.pars[p] else None
            if par is None or par.markerdata is None:
                continue
            pm = par.markerdata
            hom = (pm[:, 0] != UNKNOWN) & (pm[:, 0] == pm[:, 1])
            take = both_unknown & hom
            md[take, p] = pm[take, 0]
            ms[take, p] = 0.5

    def _family_chunks(self, ids, chunk):
        ped = self.ped
        for b0 in range(0, len(ids), chunk):
            sub = ids[b0:b0 + chunk]
            fb = gather_family(ped, sub, 0, ped.num_markers - 1)
            yield sub, fb.to(self.device, self.dtype)

    def _feasibility(self, chunk: int = 1024):
        """okvals[ind, m, r]: is any inheritance path with the focal's
        allele slot r as primary interpretation feasible (fixparents
        check), at shift 0 over all paths."""
        ids = [ind.n for ind in self.ped.inds[1:]]
        parts = []
        for _, fb in self._family_chunks(ids, chunk):
            blocks = build_blocks(fb, self.cfg, ci=True, dtype=self.dtype)
            pb0 = blocks.pb[0].sum(dim=-2)[..., 0]     # [B, M, r, fp]
            pb1 = blocks.pb[1].sum(dim=-2)[..., 0]
            e = blocks.froot[:, :, :, None, None, 0] * \
                pb0[:, :, :, :, None] * pb1[:, :, :, None, :]
            ok = (e > 0).any(dim=4).any(dim=3)
            ok_top = blocks.top[..., 0] > 0
            attop = blocks.focal_attop[:, None, None]
            parts.append(torch.where(attop, ok_top, ok).cpu().numpy())
        return ids, np.concatenate(parts, axis=0)

    def _fixparents_round(self) -> int:
        """One correction round: propagate child genotypes to parents and
        resolve (vectorized over the cohort)."""
        ped = self.ped
        ids, ok = self._feasibility()
        NI = len(ids)
        M = ped.num_markers
        lut = np.zeros(max(ids) + 1, dtype=np.int64)
        for i, n in enumerate(ids):
            lut[n] = i

        md = np.stack([ped.by_id(n).markerdata for n in ids])   # [NI,M,2]
        msu = np.stack([ped.by_id(n).markersure for n in ids])
        pars = np.array([[ped.by_id(n).pars[k] for k in range(2)]
                         for n in ids], dtype=np.int64)
        children = np.array([ped.by_id(n).children for n in ids])

        ok0, ok1 = ok[:, :, 0], ok[:, :, 1]
        # neither interpretation feasible: blank the genotype
        clear = ~ok0 & ~ok1 & ((md[..., 0] != UNKNOWN) |
                               (md[..., 1] != UNKNOWN))
        md[clear] = UNKNOWN
        msu[clear] = 0.0

        # exactly one interpretation survives: propagate
        one = ok0 ^ ok1
        r = ok1.astype(np.int64)
        probit = msu[..., 0] + msu[..., 1]
        odds = np.where(probit < 1.0,
                        probit / np.where(probit < 1.0, 1.0 - probit, 1.0),
                        1e300)

        rows_l, ms_l, vals_l, odds_l = [], [], [], []
        for k in range(2):
            u = k ^ r
            val = np.take_along_axis(md, u[..., None], axis=2)[..., 0]
            has_par = (pars[:, k] != 0)[:, None]
            send = one & has_par & (val != UNKNOWN)
            bi, mm = np.nonzero(send)
            rows_l.append(lut[pars[bi, k]])
            ms_l.append(mm)
            vals_l.append(val[bi, mm])
            odds_l.append(odds[bi, mm])
        rows = np.concatenate(rows_l)
        mms = np.concatenate(ms_l)
        vals = np.concatenate(vals_l)
        oddsv = np.concatenate(odds_l)

        alpha = np.unique(np.concatenate(
            [vals, md[md != UNKNOWN].ravel()]))
        alpha = alpha[alpha != UNKNOWN]
        A = len(alpha)
        if A == 0 or len(rows) == 0:
            any_corr = 0
        else:
            aidx = np.searchsorted(alpha, vals)
            cnt = np.zeros((NI, M, A), dtype=np.int64)
            prod = np.ones((NI, M, A))
            np.add.at(cnt, (rows, mms, aidx), 1)
            with np.errstate(over="ignore"):
                np.multiply.at(prod, (rows, mms, aidx), oddsv)
            prop = cnt > 0

            # seed the parent's own known alleles where no proposal exists
            scnt = np.zeros_like(cnt)
            sprob = np.zeros((NI, M, A))
            seed = np.zeros((NI, M, A), dtype=bool)
            for side in range(2):
                v = md[..., side]
                kn = v != UNKNOWN
                ai = np.searchsorted(alpha, np.where(kn, v, alpha[0]))
                ai = np.clip(ai, 0, A - 1)
                hit = kn & (np.take_along_axis(
                    np.broadcast_to(alpha[None, None, :], (NI, M, A)),
                    ai[..., None], axis=2)[..., 0] == v)
                put = hit & ~np.take_along_axis(
                    prop, ai[..., None], axis=2)[..., 0]
                put = put & ~np.take_along_axis(
                    seed, ai[..., None], axis=2)[..., 0]
                bi, mm = np.nonzero(put)
                seed[bi, mm, ai[bi, mm]] = True
                scnt[bi, mm, ai[bi, mm]] = children[bi]
                sprob[bi, mm, ai[bi, mm]] = msu[bi, mm, side]

            present = prop | seed
            ecnt = np.where(prop, cnt, scnt)
            eprob = np.where(prop, prod, sprob)

            known = ((md[..., 0] != UNKNOWN).astype(np.int64) +
                     (md[..., 1] != UNKNOWN).astype(np.int64))
            nvals = present.sum(axis=2)
            active = (known < 2) & prop.any(axis=2)

            ar = np.arange(A)
            first = np.argmax(present, axis=2)
            later = present & (ar[None, None, :] > first[..., None])
            second = np.argmax(later, axis=2)

            def take(x, idx):
                return np.take_along_axis(x, idx[..., None], axis=2)[..., 0]

            c0, c1 = take(ecnt, first), take(ecnt, second)
            p0, p1 = take(eprob, first), take(eprob, second)
            v0, v1 = alpha[first], alpha[second]

            def dosure(what, prob):
                w = np.maximum(what, 1)
                logv = np.log(np.maximum(prob, 1e-320)) / w * 4.0
                with np.errstate(over="ignore", invalid="ignore"):
                    v = np.exp(logv)
                    out = np.where(np.isinf(v), 1.0, v / (1.0 + v))
                return np.where(prob == 0, 0.0, out)

            case2 = active & (nvals == 2)
            case1 = active & (nvals == 1) & (known == 0)
            bi, mm = np.nonzero(case2)
            md[bi, mm, 0] = v0[bi, mm]
            md[bi, mm, 1] = v1[bi, mm]
            ctot = c0 + c1
            msu[bi, mm, 0] = dosure(ctot, p0)[bi, mm]
            msu[bi, mm, 1] = dosure(ctot, p1)[bi, mm]
            bi, mm = np.nonzero(case1)
            md[bi, mm, 0] = v0[bi, mm]
            md[bi, mm, 1] = UNKNOWN
            msu[bi, mm, 0] = dosure(c0, p0)[bi, mm]
            msu[bi, mm, 1] = 0.0
            any_corr = int(case2.sum() + case1.sum())

        # sex-marker normalisation
        swap = md[..., 0] == SEXMARKER
        md[swap] = md[swap][:, ::-1]

        for i, n in enumerate(ids):
            ind = ped.by_id(n)
            ind.markerdata[:] = md[i]
            ind.markersure[:] = msu[i]
        return any_corr

    def _compute_variances(self, chunk: int = 1024):
        """addvariance for every individual: per-marker informativeness
        from NO_EQUIVALENCE allele-difference probes, feeding the
        phase-anchor choice."""
        ped, cfg, dt = self.ped, self.cfg, self.dtype
        ids = [ind.n for ind in ped.inds[1:] if ind.haploweight is not None]
        p8 = torch.arange(8, device=self.device)
        for sub, fb in self._family_chunks(ids, chunk):
            V = [((((fb.flag2ignore[:, None] >> (1 + 3 * k)) & 7) & p8[None])
                  == 0).to(dt) for k in range(2)]               # [B, 8]
            sq = torch.zeros(fb.hw.shape[0::2], dtype=dt, device=self.device)
            for side in range(2):
                terms = []
                for a in range(2):
                    blocks = build_blocks(
                        fb, cfg, ci=True, zp=ZP_NO_EQUIVALENCE,
                        inval=fb.md[:, 0, :, a], insv=fb.ms[:, 0, :, a],
                        side=side, dtype=dt)
                    # sum over the state bits and the masked paths
                    p0, p1 = ((blocks.pb[k] *
                               V[k][:, None, None, None, :, None]).sum(
                                   dim=(-3, -2))
                              for k in range(2))          # [B, M, r, s]
                    t = blocks.froot[..., :, None, None] * \
                        p0[..., None, :, None] * p1[..., None, None, :]
                    ttop = blocks.top[..., None, None].expand(t.shape)
                    att = blocks.focal_attop[:, None, None, None, None, None]
                    terms.append(torch.where(att, ttop, t))
                # a deep branch spreads its state mass over its shift
                # axis (sum it); a branch whose parent is a recursion top
                # or missing replicates over it (pin it to 0)
                deep = [fb.exists[:, cfg.parent_slot(k)] &
                        ~fb.attop[:, cfg.parent_slot(k)] for k in range(2)]
                sel0 = (torch.arange(2, device=self.device) == 0).to(dt)
                wu = torch.where(deep[0][:, None], 1.0, sel0[None, :])
                wv = torch.where(deep[1][:, None], 1.0, sel0[None, :])
                d = terms[1] - terms[0]                  # [B, M, r, t, u, v]
                dg = (d * wu[:, None, None, None, :, None] *
                      wv[:, None, None, None, None, :]).sum(dim=(-2, -1))
                sq = sq + (dg ** 2).sum(dim=(2, 3))
            sq = sq.to("cpu", torch.float64).numpy()
            for bi, n in enumerate(sub):
                ped.by_id(n).variances[:] = sq[bi]

    def _lockhaplos(self, ind, c: int):
        """Anchor the phase at the most informative marker (see
        ``anchor_marker``)."""
        lo, hi = self.ped.chromosome_range(c)
        if ind.lockstart[c] >= hi:
            ind.lockstart[c] = 0
        start = max(lo, ind.lockstart[c])
        pick = anchor_marker(ind.variances[start:hi])
        if pick is None:
            return
        j = start + pick
        ind.haploweight[j] = 0.0 if ind.haploweight[j] <= 0.5 else 1.0
        ind.lockstart[c] = j + 1

    # ------------------------------------------------------------------
    # One iteration (doit)
    # ------------------------------------------------------------------
    def iterate(self, early: bool = False):
        ped, cfg, params = self.ped, self.cfg, self.params
        dev, dt = self.device, self.dtype
        st = self.state
        st.iter += 1
        dous = list(ped.dous)
        ped.count_children(dous_only=True)

        ids = [ind.n for ind in ped.inds[1:]]
        ind_index = {n: i for i, n in enumerate(ids)}
        M = ped.num_markers
        NI = len(ids)
        haplobase = torch.zeros((NI, M), dtype=dt, device=dev)
        haplocount = torch.zeros((NI, M), dtype=dt, device=dev)
        infacc = torch.zeros((NI, M, 2, 2), dtype=dt, device=dev)
        winners: List[Optional[FlipCandidate]] = []
        loglik = torch.zeros((), dtype=torch.float64, device=dev)
        need_coh = self.adaptive_relhaplo and bool(cfg.relskews)
        if need_coh:
            coh_num = torch.zeros((NI, M), dtype=dt, device=dev)
            coh_den = torch.zeros((NI, M), dtype=dt, device=dev)
        self._pair_pending.clear()

        # vacant slots map to the sentinel row NI (dropped by the merges)
        lut = np.full(max(ids) + 1, NI, dtype=np.int64)
        for n, i in ind_index.items():
            lut[n] = i
        lut = torch.as_tensor(lut, device=dev)

        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            for n in dous:
                ped.by_id(n).lastinved[c] = -1
            Mc = hi - lo
            dists = self._t(np.diff(ped.markerposes[lo:hi]))
            rm = self._t(rate_matrix(cfg, params, Mc - 1, ped.actrec, lo))
            bs = self._chunk_size(len(dous), Mc, need_coh)
            weight_parts = []
            for b0 in range(0, len(dous), bs):
                chunk = dous[b0:b0 + bs]
                fb = gather_family(ped, chunk, lo, hi - 1,
                                   n_variants=1).to(dev, dt)
                res, hb_p, hc_p, inf_p = scan_merged(
                    fb, dists, lut, rm, cfg, params, NI,
                    with_coherence=need_coh)
                self._pair_pending.append((list(chunk), lo, res.pair))
                loglik += res.total.sum()
                haplobase[:, lo:hi] += hb_p
                haplocount[:, lo:hi] += hc_p
                infacc[:, lo:hi] += inf_p
                if need_coh:
                    # the last marker has no right neighbour: its interval
                    # coherence stays neutral
                    coh = res.coherence.clone()
                    coh[:, Mc - 1] = 0.5
                    scatter_coherence(fb.slot_ind, fb.descendants, lo, coh,
                                      coh_num, coh_den, lut)
                if not early:
                    weight_parts.append(res.turn_weight)
                del res
            winner = None
            if not early:
                winner = self._optimise_flips(dous, lo, hi, weight_parts,
                                              haplobase, haplocount,
                                              ind_index, c)
                if winner is not None:
                    apply_flips(ped, winner, c, haplobase, haplocount,
                                ind_index)
            winners.append(winner)
            del weight_parts

        if need_coh:
            self._refresh_relhaplo(ids, coh_num, coh_den)
        any_inv = any(w is not None for w in winners)
        sf = 0.0 if any_inv else st.scalefactor
        hits = self._process_infprobs(ids, infacc, sf)
        hits += self._update_haploweights(ids, haplobase, haplocount, sf)
        self._adapt_scalefactor(any_inv, hits, len(dous))
        return dict(hitnnn=hits, inverted=any_inv,
                    scalefactor=st.scalefactor, loglik=float(loglik))

    def _refresh_relhaplo(self, ids, coh_num, coh_den):
        """Adaptive relhaplo: the descendant-weighted mean coherence where
        any was measured, clipped to [RELHAPLO_CLIP, 1 - RELHAPLO_CLIP]."""
        num = coh_num.to("cpu", torch.float64).numpy()
        den = coh_den.to("cpu", torch.float64).numpy()
        got = den > 0
        vals = np.where(got, num / np.maximum(den, 1), 0.5)
        for i, n in enumerate(ids):
            ind = self.ped.by_id(n)
            if ind.relhaplo is not None and got[i].any():
                ind.relhaplo[got[i]] = np.clip(vals[i, got[i]], RELHAPLO_CLIP,
                                               1 - RELHAPLO_CLIP)

    # -- flip optimisation ----------------------------------------------
    def _flip_static(self, dous, chrom):
        """Marker-independent flip-problem structure, cached per
        chromosome: per-family variable lists, turn->pattern maps,
        allowed-turn masks and the connected components."""
        key = ("flip_static", chrom, len(dous), dous[0], dous[-1])
        if key in self._cache:
            return self._cache[key]
        ped = self.ped
        T = self.cfg.numturns
        B = len(dous)
        t_ = np.arange(T)
        pat = np.zeros((B, T), dtype=np.int32)
        allowed = np.zeros((B, T), dtype=bool)
        varlists: List[List[int]] = [None] * B
        for b, n in enumerate(dous):
            members, exists = family_variables(ped, n)
            f2i = int(ped.missing_flag2_mask(n))
            varbits = [bit for bit in range(len(exists)) if exists[bit]]
            p = np.zeros(T, dtype=np.int32)
            for i, bit in enumerate(varbits):
                p |= ((t_ >> bit) & 1) << i
            pat[b] = p
            allowed[b] = (t_ & (f2i >> 1)) == 0
            varlists[b] = [members[bit] for bit in varbits]

        comps = _components([(vl, None) for vl in varlists])
        comp_of_fam = np.zeros(B, dtype=np.int64)
        comp_struct = []
        for ci, comp in enumerate(comps):
            vset = sorted({v for fi in comp for v in varlists[fi]})
            vidx = {v: i for i, v in enumerate(vset)}
            pos = [np.array([vidx[v] for v in varlists[fi]]) for fi in comp]
            comp_struct.append((comp, vidx, pos, len(vset)))
            for fi in comp:
                comp_of_fam[fi] = ci
        out = (varlists, pat, allowed, comp_struct, comp_of_fam)
        self._cache[key] = out
        return out

    def _optimise_flips(self, dous, lo, hi, weight_parts, haplobase,
                        haplocount, ind_index, chrom
                        ) -> Optional[FlipCandidate]:
        """Native phase-flip optimisation: device scoring of the hot
        markers, then a full solve of every component with a gainful
        family at each of them."""
        scored = self._score_turns(dous, lo, hi, weight_parts, haplobase,
                                   haplocount, ind_index, chrom)
        return self._solve_scored(dous, lo, hi, scored, chrom)

    def _score_turns(self, dous, lo, hi, weight_parts, haplobase,
                     haplocount, ind_index, chrom):
        """Device scoring of one chromosome: host (idx, mg, gains [B, k],
        S_top [B, k, P])."""
        ped, cfg = self.ped, self.cfg
        B = len(dous)
        M = hi - lo
        dt = weight_parts[0].dtype
        with_skew = bool(cfg.relskews)
        if with_skew:
            hw = np.stack([ped.by_id(n).haploweight[lo:hi] for n in dous])
            rh = np.stack([ped.by_id(n).relhaplo[lo:hi] for n in dous])
            rows = torch.as_tensor([ind_index[n] for n in dous],
                                   device=self.device)
            hb = haplobase[rows][:, lo:hi]
            hc = haplocount[rows][:, lo:hi]
        else:
            hw = rh = np.zeros((B, M))
            hb = hc = self._t(hw, dt)
        varlists, pat, allowed, comp_struct, comp_of_fam = \
            self._flip_static(dous, chrom)
        desc = np.array([ped.by_id(n).descendants for n in dous],
                        dtype=np.float64)
        focal_bit = 1 << (cfg.turnbits - 1)
        tsel = (np.arange(cfg.numturns) & focal_bit) > 0
        k = min(MAX_FLIP_MARKERS, M)
        if "flip_scorer" not in self._cache:
            self._cache["flip_scorer"] = make_flip_scorer()
        idx, mg, gains, S_top = self._cache["flip_scorer"](
            weight_parts, self._t(pat, torch.int64),
            self._t(allowed, torch.bool), self._t(hw, dt), self._t(rh, dt),
            hb, hc, self._t(desc, dt), self._t(tsel, torch.bool),
            k=k, with_skew=with_skew)

        def host(x):
            return x.to("cpu", torch.float64 if x.is_floating_point()
                        else x.dtype).numpy()

        return host(idx), host(mg), host(gains), host(S_top)

    @staticmethod
    def _canonical_scores(scored):
        """Pattern scores on an absolute grid of FLIP_SCORE_QUANTUM, with
        the family gains and marker totals recomputed from them (exact
        sums on the grid) and the markers ordered by (total, index).  The
        flip problem has many exact ties (symmetric families, markers of
        equal information) whose floating-point residue differs from one
        device to another; on the grid they stay ties, and the solve and
        the winner selection break them the same way everywhere."""
        idx, _, _, S_top = scored
        fin = np.isfinite(S_top)
        S_c = np.where(fin, np.round(np.where(fin, S_top, 0.0) /
                                     FLIP_SCORE_QUANTUM) * FLIP_SCORE_QUANTUM,
                       S_top)
        gains = S_c.max(axis=2) - S_c[:, :, 0]
        mg = np.where(gains > 1e-12, gains, 0.0).sum(axis=0)
        order = np.lexsort((idx, -mg))
        return idx[order], mg[order], gains[:, order], S_c[:, order]

    def _solve_scored(self, dous, lo, hi, scored, chrom
                      ) -> Optional[FlipCandidate]:
        """Joint flip solve over the scored hot markers (chromosome-local
        marker indices)."""
        from .native import load_flipsolve
        ped = self.ped
        idx, mg, gains, S_top = self._canonical_scores(scored)
        varlists, pat, allowed, comp_struct, comp_of_fam = \
            self._flip_static(dous, chrom)
        lib = load_flipsolve()
        plen = [1 << len(vl) for vl in varlists]

        cands: List[FlipCandidate] = []
        for j in range(len(idx)):
            if mg[j] <= 1e-12:
                continue
            m = int(idx[j])
            hot_comps = sorted(set(
                comp_of_fam[np.where(gains[:, j] > 1e-12)[0]]))
            assign = {}
            fams_m = []
            for ci in hot_comps:
                comp, vidx, pos, n = comp_struct[ci]
                fam_masks = [(pos[jj], S_top[fi, j, :plen[fi]])
                             for jj, fi in enumerate(comp)]
                vec = solve_component(fam_masks, n, lib=lib)
                for v, i in vidx.items():
                    if vec[i]:
                        assign[v] = True
                fams_m.extend((varlists[fi], S_top[fi, j, :plen[fi]])
                              for fi in comp)
            if not assign:
                continue
            cands.extend(extract_candidates(fams_m, assign, lo + m))
        # a flip of an all-0.5 tail is the identity on every parameter:
        # drop it rather than trip the inversion freeze
        for c_ in cands:
            c_.flips = [
                (n, m) for n, m in c_.flips
                if np.abs(ped.by_id(n).haploweight[m + 1:hi] - 0.5).max(
                    initial=0.0) > 1e-9]
        cands = [c_ for c_ in cands if c_.flips]
        return select_winner(cands)

    # -- parameter updates ----------------------------------------------
    def _process_infprobs(self, ids, infacc, scalefactor) -> int:
        """processinfprobs over all individuals."""
        ped = self.ped
        NI, M = infacc.shape[:2]
        inds = [ped.by_id(n) for n in ids]
        md = np.stack([ind.markerdata for ind in inds])
        msu = np.stack([ind.markersure for ind in inds])
        prior = np.stack([ind.priormarkerdata if ind.has_prior else
                          np.zeros((M, 2), dtype=np.int32) for ind in inds])
        priorsure = np.stack([ind.priormarkersure if ind.has_prior else
                              np.zeros((M, 2)) for ind in inds])
        has_prior = np.array([ind.has_prior for ind in inds])
        children = np.array([ind.children for ind in inds])
        res = update_infprobs(infacc, self._t(md, torch.int32), self._t(msu),
                              self._t(prior, torch.int32),
                              self._t(priorsure),
                              self._t(has_prior, torch.bool),
                              self._t(children), self.params,
                              float(scalefactor))
        newp = res.newprob.to("cpu", torch.float64).numpy()
        live = (infacc > 0).cpu().numpy()
        for i, ind in enumerate(inds):
            if ind.empty or not ind.has_prior:
                continue
            for side in range(2):
                probs = newp[i, :, side, :]
                lv = live[i, :, side, :]
                anym = lv.any(axis=-1)
                if not anym.any():
                    continue
                # best candidate; the side-1 epsilon reproduces the
                # reference's allele-1 tie-breaking
                pick = np.where(lv, probs, -np.inf)
                eps = 1e-30 if side == 1 else 0.0
                best = np.where(pick[:, 1] > pick[:, 0] - eps, 1, 0)
                bestp = pick[np.arange(M), best]
                take = anym & np.isfinite(bestp)
                ind.markerdata[take, side] = best[take] + 1
                ind.markersure[take, side] = 1.0 - bestp[take]
        return int(res.hits)

    def _update_haploweights(self, ids, haplobase, haplocount,
                             scalefactor) -> int:
        ped = self.ped
        NI, M = haplobase.shape
        inds = [ped.by_id(n) for n in ids]
        hw = np.stack([ind.haploweight for ind in inds])
        md = np.stack([ind.markerdata for ind in inds])
        msu = np.stack([ind.markersure for ind in inds])
        desc = np.array([ind.descendants for ind in inds])
        children = np.array([ind.children for ind in inds])
        lastinv = np.zeros((NI, M), dtype=bool)
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            lastinv[:, lo:hi] = np.array(
                [ind.lastinved[c] != -1 for ind in inds])[:, None]
        hwt = self._t(hw)
        if self.cfg.relskews:
            rh = self._t(np.stack([ind.relhaplo for ind in inds]))
            relterm = torch.zeros_like(hwt)
            for c in range(ped.num_chromosomes):
                lo, hi = ped.chromosome_range(c)
                relterm[:, lo:hi] = relskew_ratio(hwt[:, lo:hi],
                                                  rh[:, lo:hi])
        else:
            relterm = torch.full_like(hwt, 0.5)

        active = (hw > 0) & (hw < 1)
        anyinfo = torch.zeros((NI, M), dtype=torch.bool, device=self.device)
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            anyinfo[:, lo:hi] = (haplocount[:, lo:hi] > 0).any(
                dim=1, keepdim=True)
        active = self._t(active, torch.bool) & anyinfo

        res = update_haploweights(
            hwt, haplobase, haplocount, self._t(md, torch.int32),
            self._t(msu), relterm, self._t(desc), self._t(children),
            self._t(lastinv, torch.bool), active, self.params,
            float(scalefactor))
        # masked writeback: untouched lanes keep their float64 host values
        newhw = res.haploweight.to("cpu", torch.float64).numpy()
        act = active.cpu().numpy()
        for i, ind in enumerate(inds):
            a = act[i]
            ind.haploweight[a] = newhw[i][a]
        return int(res.hits)

    def _adapt_scalefactor(self, any_inv: bool, hitnnn: int, ndous: int):
        st = self.state
        old_sf = st.scalefactor
        if hitnnn > max(st.oldhitnnn, st.oldhitnnn2):
            st.scalefactor /= 1.1
        if hitnnn < max(min(st.oldhitnnn, st.oldhitnnn2),
                        ndous // self.cfg.turnbits) * 0.99:
            st.scalefactor *= 1.21
        st.scalefactor *= 0.997
        if any_inv:
            st.scalefactor = old_sf
        else:
            st.oldhitnnn2 = st.oldhitnnn
            st.oldhitnnn = hitnnn

    # ------------------------------------------------------------------
    def run(self, iterations: int):
        """The main loop: a first pass without phase flips, then full
        iterations."""
        return [self.iterate(early=(i == 0)) for i in range(iterations)]
