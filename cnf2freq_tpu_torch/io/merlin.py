"""MERLIN .map/.ped readers and ped export
(``readmerlinmap``/``readmerlinped``/``domerlinind``,
cnF2freq.cpp:6687-6793).

The port's copy of ``cnf2freq_tpu/io/merlin.py`` (numpy only), building
the port's ``Pedigree``.  As there, ``write_merlin_ped`` writes no
phenotype column, which ``read_merlin_ped`` requires: its output does not
read back.
"""

from __future__ import annotations

from typing import TextIO, Union

import numpy as np

from ..pedigree import Pedigree
from .alpha import _lines

Source = Union[str, TextIO]


def read_merlin_map(ped: Pedigree, src: Source):
    """Sex-averaged map: ``chrom name cM bp`` rows, chromosomes in order;
    positions rebased so each chromosome starts at 0."""
    poses = []
    starts = []
    oldchrom = None
    cmbase = 0.0
    for parts in _lines(src):
        if len(parts) < 4:
            continue
        chrom, _name, cmpos, _bp = parts[0], parts[1], float(parts[2]), \
            parts[3]
        if chrom != oldchrom:
            starts.append(len(poses))
            oldchrom = chrom
            cmbase = cmpos
        poses.append(cmpos - cmbase)
    starts.append(len(poses))
    ped.markerposes = np.asarray(poses)
    ped.chromstarts = starts


def read_merlin_ped(ped: Pedigree, src: Source,
                    genotype_error: float = 1e-7):
    """``fam ind father mother sex pheno  a b a b ...`` rows."""
    M = ped.num_markers
    for parts in _lines(src):
        if len(parts) < 6 + 2 * M:
            continue
        _fam, name, pname, mname, sex = parts[:5]
        ind = ped.getind(name)
        pf = ped.getind(pname) if pname != "0" else None
        pm = ped.getind(mname) if mname != "0" else None
        ind.pars = (pf.n if pf else 0, pm.n if pm else 0)
        ind.gen = 0
        ind.sex = int(sex) - 1
        if ind.pars[0] or ind.pars[1]:
            ped.dous.append(ind.n)
            ind.gen += 1
        ped.freeze()
        ind.empty = False
        geno = parts[6:6 + 2 * M]
        for k in range(M):
            a, b = int(geno[2 * k]), int(geno[2 * k + 1])
            ind.markerdata[k] = (a, b)
            ind.markersure[k] = (genotype_error if a else 0.0,
                                 genotype_error if b else 0.0)


def write_merlin_ped(ped: Pedigree, out: TextIO, family: int = 1):
    """domerlinind-style export for the first chromosome
    (cnF2freq.cpp:6777-6793)."""
    hi = ped.chromstarts[1]
    for ind in ped.inds[1:]:
        if ind.markerdata is None:
            continue
        out.write(f"{family}\t{ind.n}\t{ind.pars[0]}\t{ind.pars[1]}"
                  f"\t{ind.sex + 1}")
        for k in range(hi):
            out.write(f"\t{int(ind.markerdata[k, 0])}"
                      f"\t{int(ind.markerdata[k, 1])}")
        out.write("\n")
