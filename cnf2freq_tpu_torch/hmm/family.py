"""Family-batch tensors: the analysis units of a marker scan.

Numpy gather of everything the emission model needs into dense arrays over

    [B, SLOT, M, ...]   B = focal individuals, SLOT = 7 family slots,
                        M = markers of one chromosome.

Slot order: 0=focal, 1=parent0, 2=gp00, 3=gp01, 4=parent1, 5=gp10, 6=gp11.

Carried from ``cnf2freq_tpu/hmm/family.py`` (same arrays, same rules):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..pedigree import Pedigree

_INT_FIELDS = ("md", "flag2ignore", "shiftignore", "descendants",
               "slot_ind")
_BOOL_FIELDS = ("exists", "attop", "emptyslot", "dup_flip")


@dataclasses.dataclass
class FamilyBatch:
    """Arrays (numpy, or torch tensors after ``to``) describing B analysis
    units over M markers (the standard state space: no selfing or
    relskew-state fields)."""

    md: np.ndarray          # [B, 7, M, 2] int32 marker values
    ms: np.ndarray          # [B, 7, M, 2] float error probabilities
    hw: np.ndarray          # [B, 7, M]    float haplotype weights
    exists: np.ndarray      # [B, 7] bool  slot occupied by an individual
    attop: np.ndarray       # [B, 7] bool  slot is a recursion top (founder)
    flag2ignore: np.ndarray  # [B] int32 canonical-path masks
    shiftignore: np.ndarray  # [B] int32 disabled shift modes
    descendants: np.ndarray  # [B] int32
    slot_ind: np.ndarray    # [B, 7] int32 global individual ids (0 = none)
    emptyslot: np.ndarray = None   # [B, 7] bool
    dup_flip: np.ndarray = None    # [B, NV, 7] bool

    def to(self, device, dtype=torch.float64) -> "FamilyBatch":
        """Torch tensors on ``device``: integer fields as int32, flags as
        bool, probabilities and weights in ``dtype``."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                out[f.name] = None
                continue
            t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) \
                else v
            if f.name in _INT_FIELDS:
                t = t.to(device=device, dtype=torch.int32)
            elif f.name in _BOOL_FIELDS:
                t = t.to(device=device, dtype=torch.bool)
            else:
                t = t.to(device=device, dtype=dtype)
            out[f.name] = t
        return FamilyBatch(**out)


def gather_family(ped: Pedigree, focal_ids: Sequence[int],
                  startmark: int, endmark: int,
                  dtype=np.float64, n_variants: int = None,
                  light: bool = False) -> FamilyBatch:
    """Build the batch for markers [startmark, endmark] inclusive.  The
    canonical-path mask pins only vacant slots' path bits (the JAX
    package's "missing" mode).  n_variants: the probe-dedup variant count
    of the dup_flip axis.  light: the skeleton only (slot indices, flags,
    masks, descendants) with md/ms/hw None, for a caller that gathers
    those on the device (``resident.gather_dev``)."""
    cfg: ModelConfig = ped.config
    B = len(focal_ids)
    S = cfg.numslots
    M = endmark - startmark + 1

    if light:
        md = ms = hw = None
    else:
        md = np.zeros((B, S, M, 2), dtype=np.int32)
        ms = np.zeros((B, S, M, 2), dtype=dtype)
        hw = np.full((B, S, M), 0.5, dtype=dtype)
    exists = np.zeros((B, S), dtype=bool)
    attop = np.zeros((B, S), dtype=bool)
    f2ig = np.zeros(B, dtype=np.int32)
    shig = np.zeros(B, dtype=np.int32)
    desc = np.zeros(B, dtype=np.int32)
    slot_ind = np.zeros((B, S), dtype=np.int32)
    emptyslot = np.zeros((B, S), dtype=bool)
    unit_cons: List[List] = []

    sl = slice(startmark, endmark + 1)
    for b, n in enumerate(focal_ids):
        shig[b], _ = ped.fixtrees(n)
        f2ig[b] = ped.missing_flag2_mask(n)
        slots = ped.family_slots(n)
        desc[b] = ped.by_id(n).descendants
        for s, sid in enumerate(slots):
            if not sid:
                continue
            ind = ped.by_id(sid)
            exists[b, s] = True
            slot_ind[b, s] = sid
            emptyslot[b, s] = ind.empty
            if not light:
                md[b, s] = ind.markerdata[sl]
                ms[b, s] = ind.markersure[sl]
                hw[b, s] = ind.haploweight[sl]
            # grandparent slots are tops by depth; others by founder flag
            is_gp = s not in (0, cfg.parent_slot(0), cfg.parent_slot(1))
            attop[b, s] = ind.founder \
                or (is_gp and (cfg.numgen == 3 or cfg.deep_walk)) \
                or (cfg.numgen == 2 and s != 0 and cfg.haplotyping)
        # duplicate-member slot groups: each group of k slots contributes
        # k-1 (anchor, other) pair constraints for the probe dedup rules
        groups = {}
        for s, sid in enumerate(slots):
            if sid and not emptyslot[b, s]:
                groups.setdefault(sid, []).append(s)
        cons = [(g[0], s) for g in groups.values() if len(g) > 1
                for s in g[1:]]
        unit_cons.append(cons)
    n_local = max((1 << len(c) for c in unit_cons), default=1)
    NV = n_variants if n_variants is not None else max(4, n_local)
    if 1 < NV < n_local:
        raise ValueError(
            f"a family needs {n_local} probe-dedup variants but the "
            f"batch was built with n_variants={NV}")
    NV = max(NV, 1)
    dup_flip = np.zeros((B, NV, S), dtype=bool)
    for b, cons in enumerate(unit_cons):
        n_u = 1 << len(cons)
        for v in range(NV):
            t = v % n_u
            for ci, (anchor, other) in enumerate(cons):
                if (t >> ci) & 1:
                    dup_flip[b, v, other] ^= True
                    dup_flip[b, v, anchor] ^= True
    return FamilyBatch(md=md, ms=ms, hw=hw, exists=exists, attop=attop,
                       flag2ignore=f2ig, shiftignore=shig, descendants=desc,
                       slot_ind=slot_ind, emptyslot=emptyslot,
                       dup_flip=dup_flip)
