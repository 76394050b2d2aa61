"""Pedigree data model.

The port's own copy of ``cnf2freq_tpu/pedigree.py`` (no JAX, no import of
the JAX package), plus ``from_host``, which carries a pedigree of either
package into this one.

Replaces the reference's ``struct individ`` + global registries
(``individer[]``, ``indmap``, ``dous``; cnF2freq.cpp:853-914, 2448-2514,
6479-6493) with an explicit :class:`Pedigree` object holding plain numpy
arrays, ready to be packed into device tensors.

Individuals are stored in one table indexed by a dense integer id (1-based
to match the reference's numbering; index 0 is reserved as "nobody").
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import ModelConfig, UNKNOWN


@dataclasses.dataclass
class Individual:
    """One pedigree member; mirrors ``struct individ`` fields that are part
    of the data model (cnF2freq.cpp:853-902)."""

    n: int                         # dense 1-based id
    name: str = ""
    gen: int = 0
    sex: int = 0
    empty: bool = True             # no genotype data read for this individual
    pars: Tuple[int, int] = (0, 0)  # parent ids, 0 = missing
    founder: bool = False
    descendants: int = 0
    children: int = 0

    # per-marker data; allocated lazily by Pedigree.freeze()
    markerdata: Optional[np.ndarray] = None   # [M, 2] int32 allele values
    markersure: Optional[np.ndarray] = None   # [M, 2] float64 error probs
    haploweight: Optional[np.ndarray] = None  # [M] float64 phase weights
    relhaplo: Optional[np.ndarray] = None     # [M] float64 adjacent-phase
    priormarkerdata: Optional[np.ndarray] = None
    priormarkersure: Optional[np.ndarray] = None
    has_prior: bool = False
    negshift: Optional[np.ndarray] = None
    variances: Optional[np.ndarray] = None
    lockstart: Optional[List[int]] = None
    lastinved: Optional[List[int]] = None


class Pedigree:
    """Registry of individuals + genetic map.

    The genetic map lives here too (the reference keeps it in globals
    ``markerposes``/``chromstarts``/``actrec``; cnF2freq.cpp:233-296).
    """

    def __init__(self, config: ModelConfig = None):
        self.config = config or ModelConfig()
        self._byname: Dict[str, int] = {}
        self.inds: List[Optional[Individual]] = [None]  # index 0 = nobody
        self.dous: List[int] = []          # analysis worklist (ids)
        self.markerposes: np.ndarray = np.zeros(0)
        self.chromstarts: List[int] = []
        self.markernames: Dict[str, int] = {}  # name -> marker index
        self.actrec: Optional[np.ndarray] = None  # [2, M] per-sex rates
        self._frozen = False

    # ------------------------------------------------------------------
    def getind(self, name: str, create: bool = True) -> Optional[Individual]:
        """Name-keyed lookup, creating on miss (cnF2freq.cpp:6480-6491).
        The name "0" maps to nobody, as in the reference's ``zeroguy``."""
        if name == "0":
            return None
        if name in self._byname:
            return self.inds[self._byname[name]]
        if not create:
            return None
        n = len(self.inds)
        ind = Individual(n=n, name=name)
        self.inds.append(ind)
        self._byname[name] = n
        return ind

    def by_id(self, n: int) -> Optional[Individual]:
        if n <= 0 or n >= len(self.inds):
            return None
        return self.inds[n]

    @property
    def num_markers(self) -> int:
        return len(self.markerposes)

    @property
    def num_chromosomes(self) -> int:
        return len(self.chromstarts) - 1

    def chromosome_range(self, c: int) -> Tuple[int, int]:
        return self.chromstarts[c], self.chromstarts[c + 1]

    # ------------------------------------------------------------------
    def freeze(self):
        """Allocate per-marker arrays for every individual (the lazy sizing
        in getind, cnF2freq.cpp:2469-2508)."""
        m = self.num_markers
        nchrom = max(self.num_chromosomes, 0)
        todo = [ind for ind in self.inds[1:] if ind.markerdata is None]
        if not todo:
            self._frozen = True
            return
        # one block allocation per field, individuals get views: at
        # cohort scale (1e5 inds) per-individual np.full calls dominate
        # ingest time
        k = len(todo)
        md_blk = np.full((k, m, 2), UNKNOWN, dtype=np.int32)
        ms_blk = np.zeros((k, m, 2))
        hw_blk = np.full((k, m), 0.5)
        ns_blk = np.zeros((k, m))
        va_blk = np.zeros((k, m))
        rh_blk = np.full((k, m), 0.5) if self.config.relskews else None
        for i, ind in enumerate(todo):
            ind.markerdata = md_blk[i]
            ind.markersure = ms_blk[i]
            ind.haploweight = hw_blk[i]
            ind.negshift = ns_blk[i]
            ind.variances = va_blk[i]
            if rh_blk is not None:
                ind.relhaplo = rh_blk[i]
            ind.lockstart = [0] * nchrom
            ind.lastinved = [-1] * nchrom
        self._frozen = True

    # ------------------------------------------------------------------
    def count_descendants(self, reset: bool = True):
        """Propagate descendant counts upward (cnF2freq.cpp:3226-3256):
        every individual contributes max(own descendants, 1) to each parent,
        iterated to a fixed point; leaves end up with descendants >= 1.

        reset=False reproduces the reference exactly: its counting block
        sits INSIDE the correction-inference round loop and never zeroes
        ``descendants`` between rounds, so counts accumulate once per
        round (each round re-pushes max(descendants, 1) through a fresh
        ``upsent`` ledger).  The accumulated totals scale the relskew
        pull in updatehaploweights (cnF2freq.cpp:4692)."""
        if reset:
            for ind in self.inds[1:]:
                ind.descendants = 0
        upsent = {ind.n: 0 for ind in self.inds[1:]}
        changed = True
        while changed:
            changed = False
            for ind in self.inds[1:]:
                now = ind.descendants or 1
                now -= upsent[ind.n]
                if now > 0:
                    for p in ind.pars:
                        if p:
                            self.inds[p].descendants += now
                    upsent[ind.n] += now
                    changed = True
        for ind in self.inds[1:]:
            if ind.descendants == 0:
                ind.descendants = 1

    def count_children(self, dous_only: bool = True):
        """Child counts as rebuilt at the top of each iteration
        (cnF2freq.cpp:5222-5259)."""
        for ind in self.inds[1:]:
            ind.children = 0
        source = (self.by_id(i) for i in self.dous) if dous_only \
            else iter(self.inds[1:])
        for ind in source:
            if ind is None:
                continue
            for p in ind.pars:
                if p:
                    self.inds[p].children += 1

    # ------------------------------------------------------------------
    def family_slots(self, n: int) -> List[int]:
        """The analysis-unit slot table for focal individual ``n``:
        [focal, par0, gp00, gp01, par1, gp10, gp11] ids, 0 where missing.
        Mirrors the tree walked by fixtrees (cnF2freq.cpp:3099-3187)."""
        cfg = self.config
        out = [0] * cfg.numslots
        out[0] = n
        ind = self.by_id(n)
        if ind is None:
            return out
        for k in range(2):
            p = ind.pars[k]
            out[cfg.parent_slot(k)] = p
            if p and (cfg.numgen == 3 or cfg.deep_walk):
                par = self.by_id(p)
                for j in range(2):
                    out[cfg.grandparent_slot(k, j)] = par.pars[j]
        return out

    def fixtrees(self, n: int) -> Tuple[int, int]:
        """Compute (shiftignore, flag2ignore) masks for focal ``n``
        (fixtrees, cnF2freq.cpp:3099-3187).  A set bit in flag2ignore means
        that path bit must stay 0 (slot missing or empty); a set bit in
        shiftignore disables that shift mode.  Also marks the focal as
        founder when no ancestral information exists."""
        cfg = self.config
        ind = self.by_id(n)
        if not cfg.haplotyping:
            return 0, 0
        flag2keep = 1
        shiftkeep = 0
        anylev1 = False
        for k in range(2):
            p = self.by_id(ind.pars[k]) if ind.pars[k] else None
            if p is None:
                continue
            pslot = cfg.parent_slot(k)
            shiftval = (2 << k) if cfg.numgen == 3 else 0
            if not p.empty:
                flag2keep |= 1 << pslot
            anypars = False
            if cfg.numgen > 2:
                for j in range(2):
                    gp = self.by_id(p.pars[j]) if p.pars[j] else None
                    if gp is not None and not gp.empty:
                        flag2keep |= 1 << (pslot + j + 1)
                        anypars = True
            if anypars:
                shiftkeep |= shiftval
            if anypars or not p.empty:
                anylev1 = True
        if anylev1:
            shiftkeep |= 1
        else:
            ind.founder = True
        return (cfg.numshifts - 1) ^ shiftkeep, (cfg.numpaths - 1) ^ flag2keep

    def missing_flag2_mask(self, n: int) -> int:
        """Path bits that are genuinely unconsumed: slots with no
        individual at all.  Unlike the reference's fixtrees mask (which
        also pins *empty* members and thereby mis-biases genotype probes
        once correction inference fills their genotypes), bits of existing
        members stay explorable — the emission's duplicate-allele collapse
        already canonicalises them wherever their data is symmetric."""
        cfg = self.config
        slots = self.family_slots(n)
        mask = 0
        for s, sid in enumerate(slots):
            if s and not sid:
                mask |= 1 << s
        return mask

    def arerelated(self, a: int, b: int) -> bool:
        """Relatedness within two generations (cnF2freq.cpp:916-946)."""
        def ancestors(n, depth):
            out = {n}
            if depth >= 2:
                return out
            ind = self.by_id(n)
            for p in ind.pars if ind else ():
                if p:
                    out |= ancestors(p, depth + 1)
            return out

        aa, bb = ancestors(a, 0), ancestors(b, 0)
        if aa & bb:
            return True
        akids = {k for n in aa for k in self._kids_of(n)}
        bkids = {k for n in bb for k in self._kids_of(n)}
        return bool(akids & bkids) or b in akids or a in bkids

    def _kids_of(self, n: int) -> List[int]:
        return [ind.n for ind in self.inds[1:] if ind and n in ind.pars]


def from_host(ped) -> Pedigree:
    """An independent copy of ``ped`` as this package's ``Pedigree``.

    ``ped`` is any pedigree object with the fields of ``Pedigree`` and
    ``Individual`` (this package's, or the JAX package's, which has the
    same data model): every per-individual array is copied, and the model
    configuration is rebuilt as this package's ``ModelConfig`` from its
    dataclass fields.  Nothing of the source's package is imported."""
    src = ped.config
    cfg = ModelConfig(**{f.name: getattr(src, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    out = Pedigree(cfg)
    out._byname = dict(ped._byname)
    out.inds = [None] + [
        Individual(**{f.name: copy.deepcopy(getattr(ind, f.name))
                      for f in dataclasses.fields(Individual)})
        for ind in ped.inds[1:]]
    out.dous = list(ped.dous)
    out.markerposes = np.array(ped.markerposes, dtype=float)
    out.chromstarts = list(ped.chromstarts)
    out.markernames = dict(ped.markernames)
    out.actrec = None if ped.actrec is None else np.array(ped.actrec)
    out._frozen = ped._frozen
    if hasattr(ped, "truths"):
        out.truths = {k: np.array(v) for k, v in ped.truths.items()}
    return out
