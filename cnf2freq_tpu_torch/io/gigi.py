"""Gigi-compatible map/ped readers (``readgigidata``,
cnF2freq.cpp:7450-7515).

The port's copy of ``cnf2freq_tpu/io/gigi.py`` (numpy only), building
the port's ``Pedigree``.

Map rows: ``<chrom:int> <name> <cM:float> <extra:int>`` — one chromosome
spanning all markers (the reference pushes a single chromstarts pair).
Ped rows: ``<fam> <id> <father> <mother> <sex:int> <skip> (<a> <b>) x M``
with exact genotypes (markersure 0) copied into the prior store, and every
individual appended to the analysis worklist.
"""

from __future__ import annotations

from typing import TextIO, Union

import numpy as np

from ..pedigree import Pedigree
from .alpha import _lines

Source = Union[str, TextIO]


def read_gigi_map(ped: Pedigree, src: Source):
    """Single-chromosome map (cnF2freq.cpp:7450-7466)."""
    poses = []
    for parts in _lines(src):
        if len(parts) < 4:
            continue
        _chrom, name, cmpos = parts[0], parts[1], float(parts[2])
        ped.markernames[name] = len(poses)
        poses.append(cmpos)
    ped.markerposes = np.asarray(poses)
    ped.chromstarts = [0, len(poses)]


def read_gigi_ped(ped: Pedigree, src: Source):
    """Pedigree + exact genotypes (cnF2freq.cpp:7468-7515): everyone joins
    ``dous``; genotypes become their own priors."""
    M = ped.num_markers
    for parts in _lines(src):
        if len(parts) < 6 + 2 * M:
            continue
        _fam, name, pname, mname, sex = parts[:5]
        ind = ped.getind(name)
        pf = ped.getind(pname) if pname not in ("0", "") else None
        pm = ped.getind(mname) if mname not in ("0", "") else None
        ind.pars = (pf.n if pf else 0, pm.n if pm else 0)
        ind.sex = int(sex) - 1
        ped.dous.append(ind.n)
        if ind.pars[0] or ind.pars[1]:
            ind.gen = 1
        ped.freeze()
        ind.empty = False
        geno = parts[6:6 + 2 * M]
        for k in range(M):
            a, b = int(geno[2 * k]), int(geno[2 * k + 1])
            ind.markerdata[k] = (a, b)
            ind.markersure[k] = (0.0, 0.0)
        ind.priormarkerdata = ind.markerdata.copy()
        ind.priormarkersure = ind.markersure.copy()


def load_gigi(mapfile: str, pedfile: str,
              cfg=None) -> Pedigree:
    """Convenience loader mirroring the ``--gigimapfile/--gigipedfile``
    CLI path (cnF2freq.cpp:8027-8035)."""
    from ..config import ModelConfig
    ped = Pedigree(cfg or ModelConfig())
    read_gigi_map(ped, mapfile)
    read_gigi_ped(ped, pedfile)
    return ped
