"""Iteration driver: preprocessing and the outer EM-like loop.

Port of ``cnf2freq_tpu/driver.py`` on its unmeshed branches: per
chromosome and chunk of analysis units, the scan and the segment-sum
merges run on the device and fold into per-individual
accumulators that stay device tensors; phase flips come from the native
solver (device scoring, component solve on the host in C++) or the legacy
negshift pass (``flip_mode``, with optional parent-pair swaps); the
capped-gradient updates run on the device and write the new parameters
back into the shared ``Pedigree``.

Two forms of the iteration, chosen as the JAX package chooses them
(``_use_resident``): the device-resident one (``resident.py``, the
default for the native flip mode) keeps the per-individual state on the
device as mirrors of the ``Pedigree``, gathers family batches there, and
runs the parameter updates and the relhaplo refresh as one whole-cohort
update with one batched readback; the other gathers each chunk on the
host and runs the update stages from host stacks (``resident=False``,
and the default for negshift).  Both give the same numbers in float64
(in float32 a flipped haploweight may differ by an ulp).

Adaptive relhaplo is on by default, as in the JAX package: the scan then
carries the adjacent-phase coherence of every slot (the classic
[B, M, NS, S] pipeline of ``engine.chromosome_scan``, computed in one pass
inside the scan as the JAX package's mesh route does), the coherence is
scattered onto per-individual sums, and relhaplo is refreshed from them
before the parameter updates.  ``adaptive_relhaplo=False`` runs the v2
pipeline with relhaplo inert, the reference binary's own behaviour.

Chromosomes longer than ``marker_block`` markers run marker-blocked
(``_chromosome_blocked``, the JAX Driver's): three passes over the
chromosome's blocks (``ops.scan.blocked_carries``, then
``blocked_block_pass`` per block), so that the sweep tensors held on the
device are those of one block at any chromosome length.  Such a run takes
the host-gathered iteration; ``resident=True`` with ``marker_block`` runs
resident when no chromosome is longer than the block, and raises before
any work otherwise (the JAX Driver fails mid-iteration there).

``parity=True`` is the JAX package's strict reference-trajectory mode:
the fixtrees canonical-path mask that also pins empty members
(``mask_mode="reference"``), the gen<2 shift truncation, relhaplo inert
(the v2 pipeline), the statistics with the ignoreflag2 rule 2-3 probe
dedup over ``_n_variants()`` sign variants (the probe-rule entries of
csrc/stats.cu), an infprob merge that counts non-empty slots only,
descendants accumulated across the correction rounds, the reference-exact
flip stage of ``updates/refflips.py`` (host Python; under marker blocking
over staged whole-chromosome weights), the host-gathered iteration, and a
``run()`` that skips iteration 0 as the reference main loop does.

The two-generation families run through their engines
(``engine.scan_merged`` dispatches by config): ng2 (``ModelConfig(
numgen=2)``) with the 7-slot embedding for the correction inference and
the variances, and the no-haplotyping deep walk (``F2_NOHAPLO``), whose
iteration computes the posteriors and pair tables and updates nothing
(no variances, anchors, turn weights, flips or parameter updates).
Parity mode, the map re-estimation and marker blocking of the deep walk
refuse them before any work (``_check_family_run``); ng2 runs
marker-blocked (below).

The extended state spaces (``ModelConfig(selfing=True)``, V = 3 HBD
statuses; ``ModelConfig(relskewstates=True)``, V = 2 coherence-bit
values) run ``engine_ext`` through the same scan: the ignoreflag2 rule 2
stays on over ``_n_variants()`` sign variants (16 on selfed cohorts,
whose units hold their parent in both parent slots), the infprob merge
counts non-empty slots only, and with adaptive relhaplo the scan
delivers the coherence (RELSKEWSTATES: the coherence bit's xor-marginal,
slot 0 only; SELFING: every slot), which is scattered as the standard
space's; a RELSKEWSTATES scan reads the focal's relhaplo (the resident
cohort's ``rh`` column).  Parity mode refuses them at construction.

A marker-blocked chromosome of the ng2 family or the extended spaces
runs ``_chromosome_blocked_family`` (``blocked_families.py``, the JAX
Driver's), the F2 blocked path's structure without its per-block
follow-ups: adaptive-relhaplo coherence and map re-estimation stay
whole-chromosome features there (a notice is printed once, and relhaplo
keeps its values), and blocked nohaplo, negshift flips, parent swaps
and map re-estimation are refused before any work
(``_check_family_run``).

The Driver runs on the card unless it is given ``device="cpu"``.

Tracing: ``Driver.tracer`` (``utils/tracing.py``; a no-op ``NullTracer``
by default) gets the JAX Driver's spans and its per-iteration ``metric``
record (event "iteration": iter, hitnnn, inverted, scalefactor, flips).
Spans read the host clock and add no synchronisation, so a span around a
device stage measures what the host spent there (enqueueing, or waiting
where the stage reads back).  The spans and the port's stage each wraps:
``preprocess`` with ``correction_inference``, ``variances`` and
``lockhaplos``; per chunk ``gather`` (the host gather and upload, or the
resident device gather), ``scan`` (``scan_merged``; the port computes the
adjacent-phase coherence inside it), ``scatter`` (the accumulator merges)
and ``coherence`` (the scatter of the scan's coherence onto the
per-individual sums; the JAX Driver computes the coherence there too);
per chromosome ``flips`` (the flip stage of every flip mode and parity
mode, and the application of its winner) with ``optimise`` (the native
solver), ``score`` (the device scoring) and ``solve`` / ``filter`` (the
component solves and the identity-flip filter); ``updates`` with, on the
host-gathered iteration, ``infprobs`` (its ``stack`` and ``device``
stages) and ``haploweights``, and on the resident one ``stack``,
``device`` (the whole-cohort update and its readback) and ``writeback``;
on a marker-blocked chromosome ``carries`` (passes A and B), ``block``
and ``scatter`` per block and chunk (pass C), and ``flips`` around the
solve (the same spans on a blocked family chromosome).  The relhaplo
refresh of the host-gathered iteration and the per-block follow-ups run
outside any span, as in the JAX Driver.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import (SEXMARKER, UNKNOWN, ZP_NO_EQUIVALENCE, ModelConfig,
                     RuntimeParams)
from .engine import recomb_expectations, scan_merged
from .engine_ng2 import embed7, ng3_equiv
from .hmm.emission import build_blocks
from .hmm.family import gather_family
from .hmm.forward_backward import FBResult
from .hmm.probes import phase_coherence
from .hmm.transition import (interval_recomb, rate_matrix,
                             transition_eigenvalues)
from .ops import scan as v2
from .ops.scan import R_QUANTUM
from .parallel.mesh import pad_markers
from .pedigree import Pedigree
from .resident import (RELHAPLO_CLIP, ResidentAccum, ScanCohort,
                       coherence_slots, gather_cohort_static, gather_dev,
                       resident_updates)
from .updates.negshift import (apply_parent_swaps, negshift_flips,
                               parent_swap_candidates)
from .updates.parameter_updates import update_haploweights, update_infprobs
from .updates.phaseflip import (FlipCandidate, _components, apply_flips,
                                extract_candidates, family_variables,
                                make_flip_scorer, select_winner,
                                solve_component)
from .updates.refflips import reference_flips
from .updates.relskew import relskew_ratio
from .utils.tracing import NullTracer
from .utils.transfer import constant, fetch, upload


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
# [M, 512] tensors per unit and extension row that an extended-space scan
# chunk holds at its peak: e, the three sweep stores, the posterior
# weight, the turn transforms and one probe variant's statistics
# temporaries (the port evaluates the variants one after another, so they
# do not stack).  On an H100 the 1000 x 192 selfing slice (V = 3) peaked
# at 4.09 GB in 192-unit chunks, 54 such tensors a unit
EXT_UNIT_TENSORS = 18
# the extended spaces' chunk quantum (units), as the JAX Driver's
EXT_QUANTUM = 32
# values per (marker, unit) of a chunk's slot tensors (md, ms: 7 x 2; hw:
# 7), which the marker-blocked scan keeps for the whole chromosome
SLOT_VALUES = 35
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
_NP_DTYPES = {v: k for k, v in _DTYPES.items()}


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
                 adaptive_relhaplo: bool = True, parity: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        self.ped = ped
        self.cfg: ModelConfig = ped.config
        # the extended state spaces (SELFING, RELSKEWSTATES: engine_ext)
        self.ext = self.cfg.selfing or self.cfg.relskewstates
        if self.cfg.numgen == 3 and not self.cfg.haplotyping:
            raise NotImplementedError("a numgen == 3 model without "
                                      "haplotyping has no engine")
        if parity and (self.ext or self.cfg.numgen != 3):
            raise NotImplementedError(
                "parity mode emulates the reference's default build "
                "(numgen==3, standard state space)")
        self.params = params or RuntimeParams()
        self.state = DriverState(scalefactor=self.params.scalefactor)
        self.dtype = _torch_dtype(dtype)
        # the reference-exact trajectory (the module docstring)
        self.parity = parity
        # canonical-path masks: "reference" (parity) = the fixtrees mask,
        # which also pins empty members; "missing" pins vacant slots only
        self.mask_mode = "reference" if parity else "missing"
        # measured adjacent-phase coherence feeding relhaplo (inert in
        # parity mode, as in the reference)
        self.adaptive_relhaplo = adaptive_relhaplo and not parity
        # genetic-map re-estimation (the reference's default-off
        # DOREMAPDISTANCES, as a direct posterior EM update of per-sex
        # per-interval rates in ped.actrec)
        self.remap_distances = False
        # units per scan chunk: "auto" sizes chunks to the device memory,
        # None scans the whole cohort at once, an int fixes the size
        self.batch_size = "auto"
        # the device-resident iteration: None = auto (on for the native
        # flip mode, as in the JAX package), True / False force it
        self.resident = None
        # "native" = the joint per-marker flip solver; "negshift" = the
        # legacy single-member inversion pass (updates/negshift.py)
        self.flip_mode = "native"
        # parent-pair swap moves after the negshift pass (negshift only;
        # the CLI refuses them without it)
        self.parent_swap = False
        # marker-blocked scan: chromosomes longer than this many markers
        # run in O(marker_block) sweep memory through boundary carries
        # (ops.scan.blocked_scan_chunk); None disables
        self.marker_block = None
        # spans and per-iteration records (utils/tracing.py); swap in a
        # Tracer(sink=...) for JSON lines
        self.tracer = NullTracer()
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

    def _n_variants(self) -> int:
        """Probe-dedup sign variants: 2**(pair constraints) of the deepest
        duplicate-member family in the cohort (a member in k non-empty
        slots needs k-1 constraints), in parity mode and on the extended
        spaces (rule 2 stays on there); 1 otherwise."""
        if not (self.parity or self.ext):
            return 1
        if "n_variants" not in self._cache:
            ped, n = self.ped, 1
            for d in ped.dous:
                groups = {}
                for s, sid in enumerate(ped.family_slots(d)):
                    if sid and not ped.by_id(sid).empty:
                        groups.setdefault(sid, []).append(s)
                cons = sum(len(g) - 1 for g in groups.values() if len(g) > 1)
                n = max(n, 1 << cons)
            self._cache["n_variants"] = n
        return self._cache["n_variants"]

    def _gather(self, ids, lo: int, hi: int, light: bool = False):
        """gather_family over markers [lo, hi) with the Driver's mask mode
        and probe-dedup variants."""
        return gather_family(self.ped, ids, lo, hi - 1,
                             mask_mode=self.mask_mode, parity=self.parity,
                             n_variants=self._n_variants(), light=light)

    def _chunk_size(self, n_units: int, m_markers: int,
                    with_coherence: bool = False) -> int:
        """Units per scan chunk.  "auto" on the card: half the free device
        memory (the caching allocator's unused reserve counted as free, so
        that earlier work does not shrink the chunks) over the
        [M, NS * S] tensors a unit holds in the scan (``UNIT_TENSORS``;
        NS * S = 512 in the 64-state space, 8 and 4 in the two-generation
        families), in whole warps of units; on the CPU the whole cohort.
        The extended spaces hold ``EXT_UNIT_TENSORS`` a unit on each of
        the V rows, in quanta of 32 units."""
        if self.batch_size is None:
            return n_units
        if self.batch_size != "auto":
            return int(self.batch_size)
        if self.device.type != "cuda":
            return n_units
        free, _ = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - \
            torch.cuda.memory_allocated(self.device)
        itemsize = torch.finfo(self.dtype).bits // 8
        tensors, q = UNIT_TENSORS[with_coherence], R_QUANTUM
        if self.ext:
            V = self.cfg.numselfstates * self.cfg.numrelstates
            tensors, q = EXT_UNIT_TENSORS * V, EXT_QUANTUM
        per_unit = tensors * m_markers * self.cfg.numshifts * \
            self.cfg.numtypes * itemsize
        bs = int(0.5 * free // per_unit)
        if bs >= n_units:
            return n_units
        return max(q, bs // q * q)

    # ------------------------------------------------------------------
    # Preprocessing (postmarkerdata)
    # ------------------------------------------------------------------
    def preprocess(self):
        ped, tr = self.ped, self.tracer
        with tr.span("preprocess"):
            with tr.span("correction_inference"):
                self._correction_inference_loop()
            if not self.parity:
                ped.count_descendants()
            for ind in ped.inds[1:]:
                ped.fixtrees(ind.n)       # sets founder flags
            if self.cfg.haplotyping:
                # variances feed the phase-anchor choice (lockhaplos); the
                # no-haplotyping family has no phases to anchor
                with tr.span("variances"):
                    self._compute_variances()
            with tr.span("lockhaplos"):
                for ind in ped.inds[1:]:
                    if self.cfg.haplotyping and ind.haploweight is not None:
                        for c in range(ped.num_chromosomes):
                            self._lockhaplos(ind, c)

    def _correction_inference_loop(self):
        ped = self.ped
        if self.parity:
            # the reference accumulates descendants across the rounds
            # (count_descendants(reset=False)), from zero
            for ind in ped.inds[1:]:
                ind.descendants = 0
        while True:
            ped.count_children(dous_only=False)
            for ind in ped.inds[1:]:
                self._fixkid(ind)
            ped.count_descendants(reset=not self.parity)
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
            fb = gather_family(ped, sub, 0, ped.num_markers - 1,
                               mask_mode=self.mask_mode)
            yield sub, fb.to(self.device, self.dtype)

    def _feasibility(self, chunk: int = 1024):
        """okvals[ind, m, r]: is any inheritance path with the focal's
        allele slot r as primary interpretation feasible (fixparents
        check), at shift 0 over all paths.  The deep-walk family pins the
        focal interpretation (``engine_nohaplo.nohaplo_feasibility``); the
        other two-generation family runs the block builders on its 7-slot
        embedding."""
        ids = [ind.n for ind in self.ped.inds[1:]]
        parts = []
        for _, fb in self._family_chunks(ids, chunk):
            cfg = self.cfg
            if cfg.deep_walk:
                from .engine_nohaplo import nohaplo_feasibility
                parts.append(nohaplo_feasibility(fb, cfg, ci=True,
                                                 dtype=self.dtype).cpu()
                             .numpy())
                continue
            if cfg.numgen == 2:
                fb, cfg = embed7(fb), ng3_equiv(cfg)
            blocks = build_blocks(fb, cfg, ci=True, dtype=self.dtype)
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
        phase-anchor choice (a two-generation family through its 7-slot
        embedding)."""
        ped, dt = self.ped, self.dtype
        cfg = ng3_equiv(self.cfg) if self.cfg.numgen == 2 else self.cfg
        ids = [ind.n for ind in ped.inds[1:] if ind.haploweight is not None]
        p8 = torch.arange(8, device=self.device)
        for sub, fb in self._family_chunks(ids, chunk):
            if self.cfg.numgen == 2:
                fb = embed7(fb)
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
    def _use_resident(self) -> bool:
        """The JAX package's rule: the resident iteration for the native
        flip mode outside parity mode when no marker block is set; a
        forced resident iteration runs with a marker block that no
        chromosome exceeds (so none runs blocked), and cannot block a
        longer one, nor run parity mode (their flip stages read host
        accumulators)."""
        if self.resident is not None:
            if self.resident and self.marker_block is not None:
                for c in range(self.ped.num_chromosomes):
                    lo, hi = self.ped.chromosome_range(c)
                    if hi - lo > self.marker_block:
                        raise ValueError(
                            f"resident=True cannot run marker-blocked "
                            f"chromosomes: chromosome {c} has {hi - lo} "
                            f"markers, more than marker_block="
                            f"{self.marker_block}; leave resident at None "
                            f"(auto) or set it False")
            if self.resident and self.parity:
                raise ValueError(
                    "resident=True cannot run parity mode: leave resident "
                    "at None (auto) or set it False")
            return bool(self.resident)
        return self.marker_block is None and not self.parity and \
            self.flip_mode == "native"

    def iterate(self, early: bool = False):
        ped, cfg, params = self.ped, self.cfg, self.params
        dev, dt = self.device, self.dtype
        if self.flip_mode not in ("native", "negshift"):
            raise ValueError(f"unknown flip_mode {self.flip_mode!r}")
        # (raises before any work on a combination it cannot run)
        self._check_family_run(early)
        resident = self._use_resident()
        tr = self.tracer
        st = self.state
        st.iter += 1
        dous = list(ped.dous)
        ped.count_children(dous_only=True)

        ids = [ind.n for ind in ped.inds[1:]]
        ind_index = {n: i for i, n in enumerate(ids)}
        M = ped.num_markers
        NI = len(ids)
        need_coh = self.adaptive_relhaplo and bool(cfg.relskews or
                                                    cfg.relskewstates)
        accum = ResidentAccum(NI, M, dt, dev, with_coh=need_coh)
        winners: List[Optional[FlipCandidate]] = []
        swap_cands: list = []     # parent-pair swap hypotheses, all chroms
        loglik = torch.zeros((), dtype=torch.float64, device=dev)
        self._pair_pending.clear()

        # vacant slots map to the sentinel row NI (dropped by the merges)
        lut_h = np.full(max(ids) + 1, NI, dtype=np.int64)
        for n, i in ind_index.items():
            lut_h[n] = i
        lut = constant(lut_h, dev)

        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            for n in dous:
                ped.by_id(n).lastinved[c] = -1
            Mc = hi - lo
            if self.marker_block is not None and Mc > self.marker_block:
                if self.ext or cfg.numgen == 2:
                    winner = self._chromosome_blocked_family(
                        c, lo, hi, dous, accum, ind_index, lut, early,
                        loglik)
                else:
                    winner = self._chromosome_blocked(
                        c, lo, hi, dous, accum, ind_index, lut, early,
                        loglik, swap_cands)
                if winner is not None:
                    apply_flips(ped, winner, c, accum.hb, accum.hc,
                                ind_index)
                winners.append(winner)
                continue
            dists = np.diff(ped.markerposes[lo:hi])
            rm = rate_matrix(cfg, params, Mc - 1, ped.actrec, lo)
            if resident:
                dists, rm = upload(dists, dev, dt), upload(rm, dev, dt)
            else:
                dists, rm = self._t(dists), self._t(rm)
            bs = self._chunk_size(len(dous), Mc, need_coh)
            weight_parts = []
            remap_acc = (np.zeros((2, Mc - 1)), np.zeros(2, dtype=np.int64))
            for b0 in range(0, len(dous), bs):
                chunk = dous[b0:b0 + bs]
                with tr.span("gather"):
                    if resident:
                        fb = self._fill_family_dev(chunk, c, b0, ids, lut_h)
                    else:
                        fb = self._gather(chunk, lo, hi).to(dev, dt)
                with tr.span("scan"):
                    res, hb_p, hc_p, inf_p = scan_merged(
                        fb, dists, lut, rm, cfg, params, NI,
                        with_coherence=need_coh, probe_rules=self.parity,
                        n_variants=self._n_variants())
                with tr.span("scatter"):
                    self._pair_pending.append((list(chunk), lo, res.pair))
                    loglik += res.total.sum()
                    accum.add(lo, hb_p, hc_p, inf_p)
                if need_coh:
                    with tr.span("coherence"):
                        accum.add_coh(
                            lo, res.coherence[..., :coherence_slots(cfg)],
                            fb.slot_ind, fb.descendants, lut)
                if self.remap_distances:
                    self._accumulate_recomb(fb, dists, res, rm, remap_acc)
                    self._count_recomb(remap_acc, len(chunk))
                if not early and cfg.haplotyping:
                    weight_parts.append(res.turn_weight)
                del res
            winner = None
            if not early and cfg.haplotyping:
                with tr.span("flips"):
                    winner = self._flips(dous, lo, hi, weight_parts, accum,
                                         ind_index, c, resident, swap_cands)
                    if winner is not None and resident:
                        apply_flips(ped, winner, c)
                        rows = [(ind_index[n], m) for n, m in winner.flips]
                        accum.flip_rows(rows, hi)
                        self._flip_param(rows, hi)
                    elif winner is not None:
                        apply_flips(ped, winner, c, accum.hb, accum.hc,
                                    ind_index)
            winners.append(winner)
            del weight_parts
            if self.remap_distances:
                self._apply_recomb(lo, hi, remap_acc)

        any_inv = any(w is not None for w in winners)
        sf = 0.0 if any_inv else st.scalefactor
        if not cfg.haplotyping:
            # every update hook of the reference sits behind
            # `if (!full && HAPLOTYPING)` (cnF2freq.cpp:5554): without
            # haplotyping an iteration is a posterior computation
            hits = 0
        elif resident:
            with tr.span("updates"):
                hits, loglik = self._updates_resident(ids, accum, sf, loglik)
        else:
            if need_coh:
                self._refresh_relhaplo(ids, accum.cnum, accum.cden)
            with tr.span("updates"):
                with tr.span("infprobs"):
                    hits = self._process_infprobs(ids, accum.inf, sf)
                with tr.span("haploweights"):
                    hits += self._update_haploweights(ids, accum.hb,
                                                      accum.hc, sf)
        if swap_cands:
            # one genome-wide dominance pass after the updates (the
            # reference's parentswapnegshifts placement); the swaps change
            # the host haploweights only, so the next resident iteration
            # finds its mirror stale and uploads again
            apply_parent_swaps(ped, swap_cands)
        self._adapt_scalefactor(any_inv, hits, len(dous))
        tr.metric(event="iteration", iter=st.iter, hitnnn=hits,
                  inverted=any_inv, scalefactor=st.scalefactor,
                  flips=sum(len(w.flips) for w in winners if w is not None))
        return dict(hitnnn=hits, inverted=any_inv,
                    scalefactor=st.scalefactor, loglik=float(loglik))

    def _check_family_run(self, early: bool = False):
        """The runs a model family cannot make, refused before any work,
        as the JAX Driver refuses them: a marker-blocked chromosome of the
        no-haplotyping deep walk (whole-chromosome only), and on a blocked
        ng2 or extended chromosome the negshift flips and parent-pair
        swaps of a full iteration and the map re-estimation (standard
        space only under blocking); and the genetic-map re-estimation of
        the numgen == 2 families (its expectations come from the 7-slot
        blocks, in the JAX package too)."""
        cfg, ped = self.cfg, self.ped
        family = self.ext or cfg.numgen == 2
        blocked = self.marker_block is not None and any(
            hi - lo > self.marker_block
            for lo, hi in map(ped.chromosome_range,
                              range(ped.num_chromosomes)))
        if self.marker_block is not None and cfg.deep_walk:
            raise NotImplementedError(
                "marker-blocked scans: the no-haplotyping deep-walk "
                "engine is whole-chromosome only")
        if family and blocked:
            if self.flip_mode == "negshift" and not early:
                raise NotImplementedError(
                    "negshift x blocked runs on the standard space only")
            if self.parent_swap and not early:
                raise NotImplementedError(
                    "parent-pair swap moves are unblocked-only")
            if self.remap_distances:
                raise NotImplementedError(
                    "map re-estimation under blocked scans is "
                    "standard-space only")
        if cfg.numgen == 2 and self.remap_distances:
            raise NotImplementedError(
                "genetic-map re-estimation needs numgen == 3 (its "
                "recombination expectations come from the 7-slot blocks)")

    def _flips(self, dous, lo, hi, weight_parts, accum, ind_index, chrom,
               resident, swap_cands) -> Optional[FlipCandidate]:
        """One chromosome's phase-flip winner.  Parity mode: the
        reference-exact pipeline on the host turn weights.  negshift: the
        turn weights on the host with the descendant factor divided out,
        the legacy single-member pass, and the parent-swap hypotheses
        (scored now, applied genome-wide after the updates)."""
        if self.flip_mode == "native" and not self.parity:
            with self.tracer.span("optimise"):
                return self._optimise_flips(dous, lo, hi, weight_parts,
                                            accum, ind_index, chrom,
                                            resident)
        (weights,) = fetch([torch.cat(weight_parts).double()])
        if self.parity:
            return self._reference_flips(dous, lo, hi, weights, accum,
                                         ind_index)
        return self._negshift(dous, lo, hi, weights, swap_cands)

    def _reference_flips(self, dous, lo, hi, weights, accum, ind_index
                         ) -> Optional[FlipCandidate]:
        """Parity mode's flip stage (updates/refflips.py, the reference's
        DOTOULBAR pipeline) on a chromosome's host turn weights [B, Mc, T]
        in float64, with the accumulators' rows on the host."""
        hb, hc = fetch([accum.hb.double(), accum.hc.double()])
        return reference_flips(self.ped, self.cfg, dous, lo, hi, weights, hb,
                               hc, ind_index)

    def _negshift(self, dous, lo, hi, weights, swap_cands
                  ) -> Optional[FlipCandidate]:
        """The negshift pass over a chromosome's host turn weights
        [B, Mc, T], with the descendant factor divided out."""
        ped = self.ped
        desc = np.array([max(ped.by_id(n).descendants, 1) for n in dous],
                        dtype=float)
        unscaled = weights / desc[:, None, None]
        winner = negshift_flips(ped, dous, lo, hi, unscaled, self.cfg)
        if self.parent_swap:
            swap_cands += parent_swap_candidates(ped, dous, lo, hi, unscaled,
                                                 self.cfg)
        return winner

    # -- the device-resident iteration ----------------------------------
    def _upload_mirror(self, x: np.ndarray) -> torch.Tensor:
        """A host stack of per-individual state to the device, floats in
        the Driver's dtype (the resident mirrors' only upload)."""
        return upload(x, self.device, self.dtype if x.dtype.kind == "f"
                      else None)

    def _mirror(self, name: str, host: Dict[str, np.ndarray]):
        """This iteration's device copies of per-individual host stacks
        ({field: [NI, ...]}): the mirror ``name``'s device tensors while
        its host copies equal ``host`` exactly, so that last iteration's
        update outputs are reused and a deserialize, a masking or any
        other write to the Pedigree is uploaded afresh."""
        cur = self._cache.get(name)
        if cur is not None and cur[0] == self.state.iter:
            return cur[1]
        mirror = self._cache.get(name + "_mirror")
        if mirror is None or not all(np.array_equal(mirror["host"][k], v)
                                     for k, v in host.items()):
            mirror = dict(host=host, dev={k: self._upload_mirror(v)
                                          for k, v in host.items()})
            self._cache[name + "_mirror"] = mirror
        self._cache[name] = (self.state.iter, mirror["dev"])
        return mirror["dev"]

    def _md_ms_dev(self, ids):
        """Device markerdata and markersure (the host copy of markersure
        in the device dtype, as the update returns it)."""
        ped = self.ped
        return self._mirror("md_ms", dict(
            md=np.stack([ped.by_id(n).markerdata for n in ids]).astype(
                np.int32),
            ms=np.stack([ped.by_id(n).markersure for n in ids]).astype(
                _NP_DTYPES[self.dtype])))

    def _param_dev(self, ids):
        """Device haploweight and relhaplo, with float64 host copies; the
        phase flips of an iteration reach both through _flip_param."""
        ped = self.ped
        return self._mirror("param", dict(
            hw=np.stack([ped.by_id(n).haploweight for n in ids]),
            rh=np.stack([ped.by_id(n).relhaplo if ped.by_id(n).relhaplo
                         is not None else np.full(ped.num_markers, 0.5)
                         for n in ids])))

    def _flip_param(self, flips, hi):
        """apply_flips' haploweight inversion on the device mirror and on
        its host copy (the same arithmetic as on the Pedigree, so the
        copy keeps equal to it).  In float32 the device mirror is flipped
        in float32 and may differ from the float64 host value by an
        ulp."""
        mirror = self._cache["param_mirror"]
        ResidentAccum.flip_hw(mirror["dev"]["hw"], flips, hi)
        hw = mirror["host"]["hw"]
        for r, m in flips:
            hw[r, m + 1:hi] = 1.0 - hw[r, m + 1:hi]

    def _scan_cohort(self, ids) -> ScanCohort:
        """The iteration's device cohort for the family gathers, built at
        the first chunk from the mirrors."""
        cur = self._cache.get("cohort")
        if cur is not None and cur[0] == self.state.iter:
            return cur[1]
        mdms, param = self._md_ms_dev(ids), self._param_dev(ids)
        cohort = ScanCohort(mdms["md"], mdms["ms"], param["hw"],
                            rh=param["rh"] if self.cfg.relskewstates
                            else None)
        self._cache["cohort"] = (self.state.iter, cohort)
        return cohort

    def _fill_family_dev(self, chunk, c, b0, ids, lut_h):
        """A chunk's family batch: the skeleton (slot indices, flags,
        masks, descendants) is pedigree structure, gathered on the host
        and uploaded once per (chromosome, chunk); md/ms/hw (and, under
        RELSKEWSTATES, the focal's relhaplo) are gathered on the device
        from the iteration's cohort."""
        lo, hi = self.ped.chromosome_range(c)
        key = ("fb_light", c, b0)
        cached = self._cache.get(key)
        if cached is None or cached[0] != chunk:
            skel = self._gather(chunk, lo, hi, light=True)
            rows = lut_h[skel.slot_ind]       # vacant slots: id 0 -> row NI
            cached = (list(chunk), skel.to(self.device, self.dtype),
                      upload(rows, self.device))
            self._cache[key] = cached
        _, skel, rows = cached
        md, ms, hw, relh = gather_dev(self._scan_cohort(ids), rows, lo, hi)
        return dataclasses.replace(skel, md=md, ms=ms, hw=hw, relh=relh)

    def _cohort_static(self, ids):
        key = ("cohort_static", len(ids))
        if key not in self._cache:
            self._cache[key] = gather_cohort_static(self.ped, ids,
                                                    self.dtype, self.device)
        return self._cache[key]

    def _updates_resident(self, ids, accum, scalefactor, loglik):
        """processinfprobs, updatehaploweights and the relhaplo refresh as
        one device update (resident.resident_updates) from the
        accumulators and the mirrors, read back in one batched copy with
        the iteration's log-likelihood.  Returns (hits, loglik)."""
        ped, cfg, tr = self.ped, self.cfg, self.tracer
        C = ped.num_chromosomes
        static = self._cohort_static(ids)
        with tr.span("stack"):
            lastinv_c = np.array([[ped.by_id(n).lastinved[c] != -1
                                   for c in range(C)] for n in ids])
        with tr.span("device"):
            mdms, param = self._md_ms_dev(ids), self._param_dev(ids)
            out = resident_updates(
                cfg, self.params,
                [ped.chromosome_range(c) for c in range(C)], accum,
                mdms["md"], mdms["ms"], static, param["hw"], param["rh"],
                upload(lastinv_c, self.device), scalefactor)
            pulls = dict(md_e=out.markerdata_e, ms_e=out.markersure_e,
                         take_e=out.take_e, hw=out.haploweight,
                         active=out.active, hits=out.hits, loglik=loglik)
            if accum.cnum is not None:
                pulls.update(rh=out.relhaplo, got=out.got)
            host = dict(zip(pulls, fetch(list(pulls.values()))))
        with tr.span("writeback"):
            self._writeback_resident(ids, static, out, host)
        return int(host["hits"]), float(host["loglik"])

    def _writeback_resident(self, ids, static, out, host):
        """Masked writeback of the update's readback into the Pedigree,
        so lanes that did not move keep their float64 host values; then
        the mirrors hold the new state for the next iteration."""
        ped = self.ped
        ms_e = host["ms_e"].astype(np.float64)
        for i, r in enumerate(static.elig_rows):
            ind = ped.by_id(ids[r])
            t = host["take_e"][i]
            if t.any():
                ind.markerdata[t] = host["md_e"][i][t]
                ind.markersure[t] = ms_e[i][t]
        hw, act = host["hw"].astype(np.float64), host["active"]
        for i, n in enumerate(ids):
            ped.by_id(n).haploweight[act[i]] = hw[i][act[i]]
        # the host copies of the mirrors, as the Pedigree now holds them
        self._cache["md_ms_mirror"] = dict(
            host=dict(md=np.stack([ped.by_id(n).markerdata
                                   for n in ids]).astype(np.int32),
                      ms=np.stack([ped.by_id(n).markersure
                                   for n in ids]).astype(
                                       _NP_DTYPES[self.dtype])),
            dev=dict(md=out.markerdata, ms=out.markersure))
        mirror = self._cache["param_mirror"]
        mirror["host"]["hw"][act] = hw[act]
        mirror["dev"]["hw"] = out.haploweight
        if "rh" in host:
            # the clip again on the float64 host values (a float32 bound
            # lies just outside the float64 one)
            rh = np.clip(host["rh"].astype(np.float64), RELHAPLO_CLIP,
                         1 - RELHAPLO_CLIP)
            for i, n in enumerate(ids):
                ind, g = ped.by_id(n), host["got"][i]
                if ind.relhaplo is not None and g.any():
                    ind.relhaplo[g] = rh[i][g]
                    mirror["host"]["rh"][i][g] = rh[i][g]
            mirror["dev"]["rh"] = out.relhaplo

    def _accumulate_recomb(self, fb, dists, res, rm, acc, lo=0,
                           n_real=None):
        """Accumulation of posterior recombination expectations into
        acc = (sum [2, Mc-1], count [2]): the intervals of ``fb`` from
        column ``lo`` (the first ``n_real`` of them, default all); the
        units join the divisor through ``_count_recomb``, once a chunk."""
        p = recomb_expectations(fb, dists, res, self.cfg, self.params,
                                ratemat=rm).to("cpu", torch.float64).numpy()
        p = p[:, :n_real]
        sexes = np.asarray(self.cfg.typesexes)
        for sex in range(2):
            acc[0][sex][lo:lo + p.shape[1]] += \
                p[:, :, sexes == sex].sum(axis=(0, 2))

    def _count_recomb(self, acc, n_units: int):
        """The divisor of the rate update: each unit once per sex-matched
        meiosis bit."""
        sexes = np.asarray(self.cfg.typesexes)
        for sex in range(2):
            acc[1][sex] += n_units * int((sexes == sex).sum())

    def _apply_recomb(self, lo, hi, acc):
        """Once per chromosome per iteration: EM update of per-sex
        per-interval recombination rates from the accumulated
        expectations (replaces the reference's twicestop-probe
        machinery, cnF2freq.cpp:5586-5664, 6196-6230).  The updated
        ped.actrec feeds every later scan through ``rate_matrix``."""
        ped = self.ped
        sums, counts = acc
        if ped.actrec is None:
            ped.actrec = np.full((2, ped.num_markers), self.params.baserec)
        dists = np.diff(ped.markerposes[lo:hi])
        for sex in range(2):
            if counts[sex] == 0:
                continue
            rhat = np.clip(sums[sex] / counts[sex], 1e-8, 0.49)
            rate = np.log(1.0 - 2.0 * rhat) / np.maximum(dists, 1e-9)
            rate = np.clip(rate, -20.0, -1e-4)
            old = ped.actrec[sex, lo + 1:hi]
            ped.actrec[sex, lo + 1:hi] = 0.5 * old + 0.5 * rate

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

    def _optimise_flips(self, dous, lo, hi, weight_parts, accum, ind_index,
                        chrom, resident=False) -> Optional[FlipCandidate]:
        """Native phase-flip optimisation: device scoring of the hot
        markers, then a full solve of every component with a gainful
        family at each of them."""
        scored = self._score_turns(dous, lo, hi, weight_parts, accum,
                                   ind_index, chrom, resident)
        return self._solve_scored(dous, lo, hi, scored, chrom)

    def _score_turns(self, dous, lo, hi, weight_parts, accum, ind_index,
                     chrom, resident=False, marker_offset=0, m_span=None,
                     skew_rows=None, halo=False):
        """Device scoring of one marker span: host (idx, mg, gains [B, k],
        S_top [B, k, P]), read back in one copy.  The relskew inputs are
        hb/hc from the accumulators and hw/rh from the Pedigree, or, on
        the resident iteration, from the device mirrors (before this
        chromosome's flips, as the Pedigree is).  Marker-blocked scoring
        passes the span (``marker_offset``, ``m_span``; idx comes back
        chromosome-local), the in-progress accumulator rows as
        ``skew_rows`` (hb, hc) and ``halo``: the skew inputs then reach
        one marker past the span, for the relskew term across the block's
        right boundary."""
        ped, cfg, dev = self.ped, self.cfg, self.device
        B = len(dous)
        M = m_span if m_span is not None else hi - lo
        s0 = lo + marker_offset
        Mh = M + (1 if halo else 0)
        dt = weight_parts[0].dtype
        with_skew = bool(cfg.relskews)
        if with_skew:
            rows = constant([ind_index[n] for n in dous], dev)
            hb, hc = skew_rows if skew_rows is not None else \
                accum.rows_slice(rows, s0, M)
            if resident:
                param = self._cache["param"][1]
                hw = param["hw"][rows, s0:s0 + Mh]
                rh = param["rh"][rows, s0:s0 + Mh]
            else:
                hw = self._t(np.stack([ped.by_id(n).haploweight[s0:s0 + Mh]
                                       for n in dous]), dt)
                rh = self._t(np.stack([ped.by_id(n).relhaplo[s0:s0 + Mh]
                                       for n in dous]), dt)
        else:
            hw = rh = hb = hc = torch.zeros((B, Mh), dtype=dt, device=dev)
        varlists, pat, allowed, comp_struct, comp_of_fam = \
            self._flip_static(dous, chrom)
        desc = np.array([ped.by_id(n).descendants for n in dous],
                        dtype=np.float64)
        focal_bit = 1 << (cfg.turnbits - 1)
        tsel = (np.arange(cfg.numturns) & focal_bit) > 0
        k = min(MAX_FLIP_MARKERS, M)
        if "flip_scorer" not in self._cache:
            self._cache["flip_scorer"] = make_flip_scorer()
        with self.tracer.span("score"):
            idx, mg, gains, S_top = self._cache["flip_scorer"](
                weight_parts, constant(pat, dev, torch.int64),
                constant(allowed, dev), hw, rh, hb, hc,
                constant(desc, dev, dt), constant(tsel, dev), k=k,
                with_skew=with_skew, halo=halo)
            idx, mg, gains, S_top = fetch([idx, mg, gains, S_top])
        return (idx + marker_offset, mg.astype(np.float64),
                gains.astype(np.float64), S_top.astype(np.float64))

    # -- the marker-blocked chromosome ----------------------------------
    def _chromosome_blocked(self, c, lo, hi, dous, accum, ind_index, lut,
                            early, loglik, swap_cands
                            ) -> Optional[FlipCandidate]:
        """One chromosome in marker-blocked mode: O(marker_block) sweep
        memory at any chromosome length, plus the boundary carries of
        every batch chunk (ops.scan.blocked_carries /
        blocked_block_pass).

        Blocks outer, batch chunks inner, so that the deferred relskew-halo
        scoring of a block sees every chunk's accumulator contributions,
        as the unblocked path does; adjacent-phase coherence and map
        re-estimation run per block, with the cross-boundary interval
        stitched from the previous block's last forward column.  The
        chromosome's log-likelihood is added into ``loglik``."""
        ped, cfg, dev = self.ped, self.cfg, self.device
        if self.parent_swap and not early:
            raise NotImplementedError(
                "parent-pair swap moves are unblocked-only")
        # negshift and parity mode's flip stage consume the whole
        # chromosome's turn weights at once, so the blocks' weights are
        # staged in host memory and concatenated
        negshift = (self.flip_mode == "negshift" or self.parity) and \
            not early
        block = self.marker_block
        Mc = hi - lo
        Mp = -(-Mc // block) * block
        nblk = Mp // block
        dists = self._t(np.pad(np.diff(ped.markerposes[lo:hi]),
                               (0, Mp - Mc)))
        rm = self._t(np.pad(rate_matrix(cfg, self.params, Mc - 1, ped.actrec,
                                        lo), ((0, Mp - Mc), (0, 0))))
        NI = accum.hb.shape[0]
        with_coh = accum.cnum is not None

        # batch chunks: a block's tensors plus each unit's boundary carries
        # and whole-chromosome slot tensors, in [M, 512] tensor units
        X, NS = cfg.numtypes * cfg.numshifts, cfg.numshifts
        per_marker = UNIT_TENSORS[with_coh] * 512
        m_eff = block + -(-(2 * (X + NS) * nblk + SLOT_VALUES * Mp) //
                          per_marker) + 1
        bs = self._chunk_size(len(dous), m_eff, with_coh)
        states = []
        with self.tracer.span("carries"):
            for b0 in range(0, len(dous), bs):
                chunk = dous[b0:b0 + bs]
                fb = pad_markers(self._gather(chunk, lo, hi), Mp).to(
                    dev, self.dtype)
                bc = v2.blocked_carries(fb, dists, rm, cfg, self.params,
                                        block)
                loglik += bc.total_r[:len(chunk)].sum()
                states.append(dict(chunk=chunk, fb=fb, bc=bc, prev=None))

        rows = constant([ind_index[n] for n in dous], dev)
        remap_acc = (np.zeros((2, Mc - 1)), np.zeros(2, dtype=np.int64)) \
            if self.remap_distances else None
        coh_cols = [torch.full((len(st["chunk"]), Mc, cfg.numslots), 0.5,
                               dtype=self.dtype, device=dev)
                    for st in states] if with_coh else None
        neg_parts = [[] for _ in range(nblk)]
        scored = []
        # a block is scored one block late, so that the next block's merged
        # accumulators (all chunks) supply the right-halo column of the
        # relskew term across their boundary
        pending = None

        def score_block(off, wparts):
            scored.append(self._score_block(dous, lo, hi, accum, ind_index,
                                            c, rows, off, min(block, Mc - off),
                                            wparts))

        for i in range(nblk):
            off = i * block
            span = min(block, Mc - off)
            wparts = []
            for ci, st in enumerate(states):
                chunk = st["chunk"]
                B = len(chunk)
                with self.tracer.span("block"):
                    fb_blk, _, fb2, pair_i, hb_i, hc_i, inf_i, w = \
                        v2.blocked_block_pass(
                            st["fb"], st["bc"], i, block, lut, cfg, NI,
                            with_turn=not early, probe_rules=self.parity,
                            n_variants=self._n_variants())
                with self.tracer.span("scatter"):
                    self._pair_pending.append((list(chunk), lo + off,
                                               pair_i[:, :span]))
                    accum.add(lo + off, hb_i[:, :span], hc_i[:, :span],
                              inf_i[:, :span])
                if negshift:
                    neg_parts[i] += fetch([w[:, :span].double()])
                elif not early:
                    wparts.append(w)
                if with_coh or self.remap_distances:
                    fbres = FBResult(
                        fw_pre=v2.to_std(fb2.fw_pre, B, cfg), fw_post=None,
                        bw=v2.to_std(fb2.bw, B, cfg),
                        fw_pre_f=v2.to_std_f(fb2.fw_pre_f, B),
                        fw_post_f=None, bw_f=v2.to_std_f(fb2.bw_f, B))
                    self._blocked_followups(
                        st, fb_blk, fbres, i, off, span, block, dists, rm,
                        coh_cols[ci] if with_coh else None, remap_acc)
                    # this block's last forward column, for the next
                    # block's boundary stitch
                    st["prev"] = (fbres.fw_pre[:, -1].clone(),
                                  fbres.fw_pre_f[:, -1].clone())
                del fb2
            if wparts:
                if pending is not None:
                    score_block(*pending)
                pending = (off, wparts)
        if pending is not None:
            score_block(*pending)

        if with_coh:
            for st, coh in zip(states, coh_cols):
                accum.add_coh(lo, coh, st["fb"].slot_ind,
                              st["fb"].descendants, lut)
        if self.remap_distances:
            self._apply_recomb(lo, hi, remap_acc)
        if negshift:
            weights = np.concatenate([np.concatenate(p) for p in neg_parts],
                                     axis=1)
            if self.parity:
                return self._reference_flips(dous, lo, hi, weights, accum,
                                             ind_index)
            return self._negshift(dous, lo, hi, weights, swap_cands)
        if early or not scored:
            return None
        return self._solve_blocks(dous, lo, hi, scored, c)

    def _score_block(self, dous, lo, hi, accum, ind_index, c, rows, off,
                     span, wparts):
        """Device scoring of one block's hot markers (``_score_turns`` on
        the block's span), the relskew inputs reaching one marker past a
        block that is not the chromosome's last (its right halo)."""
        halo = lo + off + span < hi
        return self._score_turns(
            dous, lo, hi, [w[:, :span] for w in wparts], accum, ind_index,
            c, marker_offset=off, m_span=span, halo=halo,
            skew_rows=accum.rows_slice(rows, lo + off,
                                       span + (1 if halo else 0)))

    def _solve_blocks(self, dous, lo, hi, scored, c
                      ) -> Optional[FlipCandidate]:
        """The flip solve of a blocked chromosome over its blocks' scored
        hot markers: on the score grid, the global top kept."""
        idx, mg, gains, S_top = self._canonical_scores(tuple(
            np.concatenate([s[j] for s in scored], axis=0 if j < 2 else 1)
            for j in range(4)))
        k = MAX_FLIP_MARKERS
        with self.tracer.span("flips"):
            return self._solve_scored(dous, lo, hi, (idx[:k], mg[:k],
                                                     gains[:, :k],
                                                     S_top[:, :k]), c)

    def _chromosome_blocked_family(self, c, lo, hi, dous, accum, ind_index,
                                   lut, early, loglik
                                   ) -> Optional[FlipCandidate]:
        """One chromosome of the ng2 family or an extended space in
        marker-blocked mode (blocked_families.py): O(marker_block) sweep
        memory at any chromosome length, plus the boundary carries of
        every batch chunk.  Blocks outer, chunks inner, with the F2
        blocked path's one-block scoring deferral for the relskew halo.
        Adaptive-relhaplo coherence stays a whole-chromosome feature here,
        as in the JAX Driver: a notice is printed once and relhaplo keeps
        its values.  The chromosome's log-likelihood is added into
        ``loglik``."""
        from .blocked_families import blocked_family_chunk, family_carries
        ped, cfg, dev = self.ped, self.cfg, self.device
        if self.adaptive_relhaplo and (cfg.relskews or cfg.relskewstates) \
                and not getattr(self, "_warned_blocked_coh", False):
            print("# blocked mode (ng2/ext): adaptive-relhaplo coherence is "
                  "a whole-chromosome feature; relhaplo keeps its current "
                  "values", file=sys.stderr)
            self._warned_blocked_coh = True
        block = self.marker_block
        Mc = hi - lo
        Mp = -(-Mc // block) * block
        nblk = Mp // block
        dists = self._t(np.pad(np.diff(ped.markerposes[lo:hi]),
                               (0, Mp - Mc)))
        rm = self._t(np.pad(rate_matrix(cfg, self.params, Mc - 1, ped.actrec,
                                        lo), ((0, Mp - Mc), (0, 0))))
        NI = accum.hb.shape[0]

        # batch chunks: a block's tensors plus each unit's boundary carries
        # and whole-chromosome slot tensors, in the tensor units of
        # _chunk_size (EXT_UNIT_TENSORS a V row on the extended spaces)
        NS, S = cfg.numshifts, cfg.numtypes
        V = cfg.numselfstates * cfg.numrelstates if self.ext else 1
        tensors = EXT_UNIT_TENSORS * V if self.ext else UNIT_TENSORS[False]
        m_eff = block + -(-(2 * (V * NS * S + NS) * nblk + SLOT_VALUES * Mp)
                          // (tensors * NS * S)) + 1
        bs = self._chunk_size(len(dous), m_eff)
        gens = []
        with self.tracer.span("carries"):
            for b0 in range(0, len(dous), bs):
                chunk = dous[b0:b0 + bs]
                fb = pad_markers(self._gather(chunk, lo, hi), Mp).to(
                    dev, self.dtype)
                fc = family_carries(fb, dists, rm, cfg, self.params, block,
                                    Mc)
                loglik += fc.total.sum()
                gens.append((chunk, blocked_family_chunk(
                    fb, dists, rm, lut, cfg, self.params, block, NI,
                    self._n_variants(), with_turn=not early, carries=fc)))

        rows = constant([ind_index[n] for n in dous], dev)
        scored = []
        # a block is scored one block late, so that the next block's merged
        # accumulators (all chunks) supply the right-halo column of the
        # relskew term across their boundary
        pending = None

        def score_block(off, wparts):
            scored.append(self._score_block(dous, lo, hi, accum, ind_index,
                                            c, rows, off, min(block, Mc - off),
                                            wparts))

        for i in range(nblk):
            # every block holds a real marker: Mp - Mc < block
            off = i * block
            span = min(block, Mc - off)
            wparts = []
            for chunk, gen in gens:
                with self.tracer.span("block"):
                    _, pair_i, hb_i, hc_i, inf_i, w = next(gen)
                with self.tracer.span("scatter"):
                    self._pair_pending.append((list(chunk), lo + off,
                                               pair_i[:, :span]))
                    accum.add(lo + off, hb_i[:, :span], hc_i[:, :span],
                              inf_i[:, :span])
                if not early:
                    wparts.append(w)
            if wparts:
                if pending is not None:
                    score_block(*pending)
                pending = (off, wparts)
        if pending is not None:
            score_block(*pending)
        if early or not scored:
            return None
        return self._solve_blocks(dous, lo, hi, scored, c)

    def _blocked_followups(self, st, fb_blk, fbres, i, off, span, block,
                           dists, rm, coh, remap_acc):
        """Per-(chunk, block) adjacent-phase coherence (into ``coh``
        [B, Mc, 7]) and recombination expectations: the block's own
        intervals from its sweep tensors, the interval (off-1, off) across
        the boundary stitched from the previous block's last forward
        column against this block's first backward column."""
        cfg = self.cfg
        n_real = span - 1
        d_blk, rm_blk = dists[off:off + block - 1], rm[off:off + block - 1]
        if n_real > 0:
            if coh is not None:
                coh[:, off:off + n_real] = self._coherence(
                    fb_blk, d_blk, fbres, rm_blk)[:, :n_real]
            if remap_acc is not None:
                self._accumulate_recomb(fb_blk, d_blk, fbres, rm_blk,
                                        remap_acc, lo=off, n_real=n_real)
        if i == 0 and remap_acc is not None:
            # every unit counts once per chunk, not once per block
            self._count_recomb(remap_acc, fbres.fw_pre.shape[0])
        if i == 0 or st["prev"] is None:
            return
        pfp, pff = st["prev"]
        zero, zero_f = torch.zeros_like(pfp), torch.zeros_like(pff)
        two = FBResult(
            fw_pre=torch.stack([pfp, zero], dim=1), fw_post=None,
            bw=torch.stack([torch.ones_like(pfp), fbres.bw[:, 0]], dim=1),
            fw_pre_f=torch.stack([pff, zero_f], dim=1), fw_post_f=None,
            bw_f=torch.stack([zero_f, fbres.bw_f[:, 0]], dim=1))
        cols = v2.marker_slice(st["fb"], slice(off - 1, off + 1))
        d2, rm2 = dists[off - 1:off], rm[off - 1:off]
        if coh is not None:
            coh[:, off - 1] = self._coherence(cols, d2, two, rm2)[:, 0]
        if remap_acc is not None:
            self._accumulate_recomb(cols, d2, two, rm2, remap_acc,
                                    lo=off - 1)

    def _coherence(self, fb, dists, fbres, rm):
        """All-slot adjacent-phase coherence [B, K, 7] of a marker span
        from its sweep tensors (the last column is 0.5 padding)."""
        cfg, dt = self.cfg, self.dtype
        lam = transition_eigenvalues(cfg, interval_recomb(
            cfg, self.params, dists, ratemat=rm)).to(dt)
        fbres = fbres._replace(fw_post=fbres.fw_pre,
                               fw_post_f=fbres.fw_pre_f)
        return phase_coherence(fbres, build_blocks(fb, cfg, dtype=dt), fb,
                               cfg, lam)

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
        with self.tracer.span("solve"):
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
        with self.tracer.span("filter"):
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
        with self.tracer.span("stack"):
            md = np.stack([ind.markerdata for ind in inds])
            msu = np.stack([ind.markersure for ind in inds])
            prior = np.stack([ind.priormarkerdata if ind.has_prior else
                              np.zeros((M, 2), dtype=np.int32)
                              for ind in inds])
            priorsure = np.stack([ind.priormarkersure if ind.has_prior else
                                  np.zeros((M, 2)) for ind in inds])
            has_prior = np.array([ind.has_prior for ind in inds])
            children = np.array([ind.children for ind in inds])
        with self.tracer.span("device"):
            res = update_infprobs(infacc, self._t(md, torch.int32),
                                  self._t(msu), self._t(prior, torch.int32),
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
    def line_origin_tables(self) -> Dict[int, np.ndarray]:
        """{focal id: [M, 3]} posterior line-origin class tables (the
        reference's zeropropagate gstr probe as a reporter,
        cnF2freq.cpp:5512) for every analysis individual: a fresh
        forward/backward per chromosome and chunk of units."""
        from .engine import line_origin
        ped, cfg = self.ped, self.cfg
        dous = list(ped.dous)
        tabs = {n: np.zeros((ped.num_markers, 3)) for n in dous}
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            Mc = hi - lo
            dists = self._t(np.diff(ped.markerposes[lo:hi]))
            rm = self._t(rate_matrix(cfg, self.params, Mc - 1, ped.actrec,
                                     lo))
            bs = self._chunk_size(len(dous), Mc, with_coherence=True)
            for b0 in range(0, len(dous), bs):
                chunk = dous[b0:b0 + bs]
                fb = gather_family(ped, chunk, lo, hi - 1,
                                   mask_mode=self.mask_mode).to(self.device,
                                                                self.dtype)
                P = line_origin(fb, dists, cfg, self.params, ratemat=rm)
                P = P.to("cpu", torch.float64).numpy()
                for i, n in enumerate(chunk):
                    tabs[n][lo:hi] = P[i]
        return tabs

    # ------------------------------------------------------------------
    def run(self, iterations: int):
        """The main loop: a first pass without phase flips, then full
        iterations.  Parity mode runs no iteration 0 (the reference main
        loop's ``if (!early) doit``): None, then iterations - 1 full
        ones."""
        if self.parity:
            return [None] + [self.iterate(early=False)
                             for _ in range(iterations - 1)]
        return [self.iterate(early=(i == 0)) for i in range(iterations)]
