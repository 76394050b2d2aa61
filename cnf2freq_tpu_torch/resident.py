"""Device-resident iteration state: accumulate, flip and update on the
device (port of ``cnf2freq_tpu/resident.py``, the pieces the unmeshed
Driver uses: the F2 model, the two-generation families, whose units
hold 3 slots (ng2) or 7 (the deep-walk nohaplo family), and the extended
state spaces, whose RELSKEWSTATES scans read the focal's relhaplo (the
cohort's ``rh`` column, ``ScanCohort(rh=)``); every gather here takes the
slot count from the batch).

Per iteration the per-individual state (markerdata, markersure,
haploweight, relhaplo) stays on the device as mirrors of the host
``Pedigree``; family batches are gathered from them on the device
(``ScanCohort``, ``gather_dev``); scan partials fold into device
accumulators (``ResidentAccum``), phase flips are mirrored onto them, and
processinfprobs, updatehaploweights and the adaptive-relhaplo refresh run
as one whole-cohort update (``resident_updates``) whose outputs cross to
the host in one batched copy.  Plain functions on tensors: no program
cache and no buffer donation.

Not carried over, and why:

* ``make_coherence_all`` serialises the per-slot coherence programs so
  that XLA's temporaries fit 16 GiB of TPU memory.  The port computes the
  coherence inside the classic scan (``engine.chromosome_scan(
  with_coherence=True)``; the ng2 engine's per-slot coherence there is
  ``coherence_slot_ng2``'s math, with no shared pair total), and
  ``updates/scatter.scatter_coherence`` is already the device form of
  ``scatter_coh``, so ``ResidentAccum.add_coh`` calls it.  The extended
  spaces' scan delivers its coherence too, so ``make_scatter_coh_ext``
  reduces to its slot rule (``coherence_slots``).  The
  no-haplotyping family measures no coherence and runs no update: its
  resident iteration only accumulates (zeros) and reports;
* the padded marker layout (``_layout_prog``, ``_layout_prog_2d``, the
  Driver's ``marker_bucket``) exists so that XLA compiles one program per
  bucket of chromosome lengths; the port compiles no shapes, so a
  chromosome's columns are its own (Mp = Mc).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .config import ModelConfig, RuntimeParams
from .updates.parameter_updates import update_haploweights, update_infprobs
from .updates.relskew import relskew_ratio
from .parallel.collective import all_sum, gather_units
from .updates.scatter import scatter_coherence
from .utils.transfer import constant, upload

# relhaplo stays inside (RELHAPLO_CLIP, 1 - RELHAPLO_CLIP)
RELHAPLO_CLIP = 1e-4


class ResidentAccum:
    """Per-iteration accumulators on the device: hb, hc [NI, M],
    inf [NI, M, 2, 2] and, with coherence, cnum, cden [NI, M]."""

    def __init__(self, NI: int, M: int, dtype: torch.dtype, device,
                 with_coh: bool):
        def z(*shape):
            return torch.zeros((NI, M) + shape, dtype=dtype, device=device)
        self.hb, self.hc, self.inf = z(), z(), z(2, 2)
        self.cnum = z() if with_coh else None
        self.cden = z() if with_coh else None

    def add(self, lo: int, hb_p, hc_p, inf_p):
        """Fold one chunk's merged partials [NI, Mc, ...] in at column
        lo."""
        hi = lo + hb_p.shape[1]
        self.hb[:, lo:hi] += hb_p
        self.hc[:, lo:hi] += hc_p
        self.inf[:, lo:hi] += inf_p

    def add_coh(self, lo: int, coh, slot_ind, descendants, lut,
                group=None):
        """Scatter one chunk's coherence [B, Mc, slots] onto cnum/cden
        (the first ``coh.shape[-1]`` slots of ``slot_ind``); the last
        marker has no right neighbour, so its interval coherence stays
        neutral.  With ``group`` (a mesh's; None unmeshed), the chunk's
        units are this rank's and the partials are summed over the
        group's ranks first."""
        slot_ind = slot_ind[:, :coh.shape[-1]]
        coh = coh.clone()
        coh[:, -1] = 0.5
        num, den = scatter_coh_sharded(coh, slot_ind, descendants, lut,
                                       self.cnum.shape[0], group)
        hi = lo + coh.shape[1]
        self.cnum[:, lo:hi] += num
        self.cden[:, lo:hi] += den

    def flip_rows(self, flips: Sequence[Tuple[int, int]], hi: int):
        """hb[r, m+1:hi] <- hc - hb for each (row, marker), in list order
        (apply_flips' accumulator mirror)."""
        for r, m in flips:
            self.hb[r, m + 1:hi] = self.hc[r, m + 1:hi] - self.hb[r, m + 1:hi]

    @staticmethod
    def flip_hw(hw, flips: Sequence[Tuple[int, int]], hi: int):
        """The device haploweight mirror's form of apply_flips, in place:
        hw[r, m+1:hi] <- 1 - hw[r, m+1:hi], in list order."""
        for r, m in flips:
            hw[r, m + 1:hi] = 1.0 - hw[r, m + 1:hi]

    def rows_slice(self, rows, s0: int, span: int):
        """The flip scorer's views: hb, hc [len(rows), span]."""
        return (self.hb[rows, s0:s0 + span], self.hc[rows, s0:s0 + span])


def scatter_coh_sharded(coh, slot_ind, descendants, lut,
                        num_individuals: int, group):
    """The coherence scatter of one chunk (port of
    ``make_scatter_coh_sharded``): this rank's units' coherence
    [B, Mc, S] onto descendant-weighted [NI, Mc] num / den partials,
    summed over the ranks of ``group`` (None unmeshed: the chunk's
    own)."""
    shape = (num_individuals, coh.shape[1])
    num = torch.zeros(shape, dtype=coh.dtype, device=coh.device)
    den = torch.zeros_like(num)
    scatter_coherence(slot_ind, descendants, 0, coh, num, den, lut)
    return all_sum([num, den], group)


@dataclasses.dataclass
class CohortStatic:
    """Per-run device tensors of the update (uploaded once)."""

    prior: torch.Tensor        # [NI, M, 2] int32
    priorsure: torch.Tensor    # [NI, M, 2]
    has_prior: torch.Tensor    # [NI] bool
    eligible: torch.Tensor     # [NI] bool (has_prior and not empty)
    children: torch.Tensor     # [NI]
    descendants: torch.Tensor  # [NI]
    has_rh: torch.Tensor       # [NI] bool (relhaplo allocated)
    elig_rows: np.ndarray      # host indices of the eligible rows
    elig_idx: Optional[torch.Tensor]  # the same on the device, or None
    # when every row is eligible


def gather_cohort_static(ped, ids: Sequence[int], dtype: torch.dtype,
                         device) -> CohortStatic:
    M = ped.num_markers
    NI = len(ids)
    prior = np.zeros((NI, M, 2), dtype=np.int32)
    psure = np.zeros((NI, M, 2))
    hasp = np.zeros(NI, dtype=bool)
    elig = np.zeros(NI, dtype=bool)
    children = np.zeros(NI)
    desc = np.zeros(NI)
    hasrh = np.zeros(NI, dtype=bool)
    for i, n in enumerate(ids):
        ind = ped.by_id(n)
        hasp[i] = ind.has_prior
        elig[i] = ind.has_prior and not ind.empty
        children[i] = ind.children
        desc[i] = ind.descendants
        hasrh[i] = ind.relhaplo is not None
        if ind.has_prior:
            prior[i] = ind.priormarkerdata
            psure[i] = ind.priormarkersure
    rows = np.nonzero(elig)[0]
    return CohortStatic(
        prior=upload(prior, device), priorsure=upload(psure, device, dtype),
        has_prior=upload(hasp, device), eligible=upload(elig, device),
        children=upload(children, device, dtype),
        descendants=upload(desc, device, dtype),
        has_rh=upload(hasrh, device), elig_rows=rows,
        elig_idx=upload(rows, device) if len(rows) < NI else None)


class ResidentUpdate(NamedTuple):
    markerdata: torch.Tensor   # [NI, M, 2] int32: next iteration's mirror
    markersure: torch.Tensor   # [NI, M, 2]
    haploweight: torch.Tensor  # [NI, M]: inactive lanes keep their input
    relhaplo: torch.Tensor     # [NI, M]
    active: torch.Tensor       # [NI, M] bool: haploweight lanes that moved
    got: torch.Tensor          # [NI, M] bool: relhaplo lanes refreshed
    hits: torch.Tensor         # []
    # compact readback of the eligible rows only (the others never take)
    markerdata_e: torch.Tensor  # [NE, M, 2] int8
    markersure_e: torch.Tensor  # [NE, M, 2]
    take_e: torch.Tensor        # [NE, M, 2] bool


def resident_updates(cfg: ModelConfig, params: RuntimeParams,
                     chrom_ranges: Sequence[Tuple[int, int]],
                     accum: ResidentAccum, md, ms, static: CohortStatic, hw,
                     rh, lastinv_c, scalefactor: float, group=None
                     ) -> ResidentUpdate:
    """processinfprobs then updatehaploweights over the whole cohort from
    the device accumulators (cnF2freq.cpp:4179-4323, 4533-4734), after the
    adaptive-relhaplo refresh from accum.cnum/cden when coherence is on.
    The arithmetic is that of the non-resident Driver's host stages:
    relhaplo = clip(num / max(den, 1)) on measured lanes; the best
    candidate with the side-1 1e-30 epsilon (the reference's allele-1
    tie-breaking); haploweights from the new markerdata/markersure.
    lastinv_c [NI, C] bool: a flip on chromosome c this iteration.

    With ``group`` (a mesh's "data" group) the update is row-sharded:
    this rank updates rows [r * per, (r + 1) * per) of the NI rows, per =
    ceil(NI / ranks) (every lane is its own, so the rows are exact
    slices of the whole update; the capped steps' early stop is per
    rank and exact, done lanes being frozen), the hit counts are summed
    and the outputs gathered whole over the group's ranks."""
    NI = hw.shape[0]
    rows = slice(None)
    if group is not None:
        nd, r = dist.get_world_size(group), dist.get_rank(group)
        per = -(-NI // nd)
        rows = slice(r * per, min(NI, (r + 1) * per))
    cnum = None if accum.cnum is None else accum.cnum[rows]
    newmd, newms, newhw, rh, active, got, take, hits = _update_rows(
        cfg, params, chrom_ranges, accum.hb[rows], accum.hc[rows],
        accum.inf[rows], cnum, None if cnum is None else accum.cden[rows],
        md[rows], ms[rows], static, rows, hw[rows], rh[rows],
        lastinv_c[rows], scalefactor)
    newmd, newms, newhw, rh, active, got, take = gather_units(
        [newmd, newms, newhw, rh, active, got, take], NI, group)
    (hits,) = all_sum([hits], group)
    e = static.elig_idx
    return ResidentUpdate(
        markerdata=newmd, markersure=newms, haploweight=newhw,
        relhaplo=rh, active=active, got=got, hits=hits,
        markerdata_e=(newmd if e is None else newmd[e]).to(torch.int8),
        markersure_e=newms if e is None else newms[e],
        take_e=take if e is None else take[e])


def _update_rows(cfg, params, chrom_ranges, hb, hc, inf, cnum, cden, md, ms,
                 static: CohortStatic, rows: slice, hw, rh, lastinv_c,
                 scalefactor):
    """The update of ``resident_updates`` on the rows ``rows`` of the
    cohort (every tensor argument but ``static`` already sliced):
    (markerdata, markersure, haploweight, relhaplo, active, got, take,
    hits)."""
    dtype = hw.dtype
    n, M = hw.shape
    has_rh = static.has_rh[rows]
    if cnum is not None:
        got = cden > 0
        vals = torch.where(got, cnum / torch.clamp(cden, min=1), 0.5)
        rh = torch.where(got & has_rh[:, None],
                         torch.clamp(vals, RELHAPLO_CLIP, 1 - RELHAPLO_CLIP),
                         rh)
    else:
        got = torch.zeros_like(hw, dtype=torch.bool)
    # processinfprobs first: the haploweight similarity damping reads the
    # genotypes it just updated
    ires = update_infprobs(inf, md, ms, static.prior[rows],
                           static.priorsure[rows], static.has_prior[rows],
                           static.children[rows], params, scalefactor)
    live = inf > 0
    pick = torch.where(live, ires.newprob, -torch.inf)
    eps = constant([0.0, 1e-30], hw.device, dtype)
    best = (pick[..., 1] > pick[..., 0] - eps).long()     # [n, M, 2]
    bestp = torch.gather(pick, -1, best[..., None])[..., 0]
    take = live.any(dim=-1) & torch.isfinite(bestp) & \
        static.eligible[rows][:, None, None]
    newmd = torch.where(take, (best + 1).to(md.dtype), md)
    newms = torch.where(take, 1.0 - bestp, ms)

    relterm = torch.full_like(hw, 0.5)
    active = (hw > 0) & (hw < 1)
    lastinv = torch.zeros((n, M), dtype=torch.bool, device=hw.device)
    for c, (lo, hi) in enumerate(chrom_ranges):
        if cfg.relskews:
            relterm[:, lo:hi] = relskew_ratio(hw[:, lo:hi], rh[:, lo:hi])
        active[:, lo:hi] &= (hc[:, lo:hi] > 0).any(dim=1, keepdim=True)
        lastinv[:, lo:hi] = lastinv_c[:, c:c + 1]
    hres = update_haploweights(hw, hb, hc, newmd, newms, relterm,
                               static.descendants[rows],
                               static.children[rows], lastinv, active,
                               params, scalefactor)
    return (newmd, newms, hres.haploweight, rh, active, got, take,
            ires.hits + hres.hits)


def coherence_slots(cfg: ModelConfig) -> int:
    """The slots whose scan coherence feeds relhaplo (the slot rule of
    ``make_scatter_coh_ext``): under RELSKEWSTATES the coherence bit's
    xor-marginal in slot 0 only (the others are neutral and must not be
    scattered), else every slot."""
    return 1 if cfg.relskewstates else cfg.numslots


class ScanCohort:
    """The iteration's cohort tensors for the device family gather:
    md [NI+1, M, 2], ms [NI+1, M, 2], hw [NI+1, M] from the device
    mirrors, with row NI the vacant-slot sentinel (md 0, ms 0, hw 0.5),
    and with ``rh`` (RELSKEWSTATES) the relhaplo column [NI+1, M]
    (sentinel 0.5).  One cohort replaces the per-chunk host stacking and
    upload of [B, slots, Mc]-shaped md/ms/hw."""

    def __init__(self, md, ms, hw, rh=None):
        def with_sentinel(x, fill):
            pad = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                             device=x.device)
            return torch.cat([x, pad])
        self.md = with_sentinel(md, 0)
        self.ms = with_sentinel(ms, 0.0)
        self.hw = with_sentinel(hw, 0.5)
        self.rh = None if rh is None else with_sentinel(rh, 0.5)


def gather_dev(cohort: ScanCohort, rows, lo: int, hi: int):
    """md [B, S, Mc, 2], ms [B, S, Mc, 2], hw [B, S, Mc] and relh [B, Mc]
    (the focal rows' relhaplo; None without the cohort's rh) of one
    chunk: rows [B, S] (S slots a unit; the sentinel row for a vacant
    slot), markers [lo, hi)."""
    relh = None if cohort.rh is None else cohort.rh[rows[:, 0], lo:hi]
    return (cohort.md[rows, lo:hi], cohort.ms[rows, lo:hi],
            cohort.hw[rows, lo:hi], relh)
