"""Cross-validation masking and imputation comparison.

The port's copy of ``cnf2freq_tpu/io/masking.py`` (numpy only).

``--clear``/``--protmarkers``/``--protinds`` genotype masking
(cnF2freq.cpp:7518-7570) and the ``--impoutput`` imputed-table comparison
(cnF2freq.cpp:7572-7623).
"""

from __future__ import annotations

from typing import Set, TextIO, Union

import numpy as np

from ..config import UNKNOWN
from ..pedigree import Pedigree

Source = Union[str, TextIO]


def read_protected_markers(src: Source) -> Set[float]:
    """File of protected cM positions; a leading 'map marker positions'
    header is skipped."""
    close = isinstance(src, str)
    f = open(src) if close else src
    try:
        toks = f.read().split()
    finally:
        if close:
            f.close()
    out = set()
    for t in toks:
        try:
            out.add(float(t))
        except ValueError:
            continue
    return out


def read_protected_individuals(ped: Pedigree, src: Source) -> Set[int]:
    """Two-column (family, name) rows; second column is the name."""
    close = isinstance(src, str)
    f = open(src) if close else src
    out = set()
    try:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                ind = ped.getind(parts[1], create=False)
                if ind is None:
                    import sys
                    print(f"Incorrect individual name. {parts[1]}",
                          file=sys.stderr)
                else:
                    out.add(ind.n)
    finally:
        if close:
            f.close()
    return out


def clear_unprotected(ped: Pedigree, protinds: Set[int],
                      protmarkers: Set[float]):
    """Blank genotypes of unprotected analysis individuals at every marker
    strictly before each protected position (the reference's walk,
    cnF2freq.cpp:7551-7569: protected positions themselves survive)."""
    for n in ped.dous:
        if n in protinds:
            continue
        ind = ped.by_id(n)
        last = 0
        for p in sorted(protmarkers):
            while last < ped.num_markers and ped.markerposes[last] < p:
                ind.markerdata[last] = (UNKNOWN, UNKNOWN)
                ind.markersure[last] = (0.0, 0.0)
                if ind.has_prior:
                    ind.priormarkerdata[last] = (UNKNOWN, UNKNOWN)
                    ind.priormarkersure[last] = (0.0, 0.0)
                last += 1
            last += 1


def compare_imputed_output(ped: Pedigree, table: TextIO,
                           out: TextIO) -> int:
    """Diff a previous run's 3-class genotype table against current
    markerdata; prints mismatches, returns their count."""
    mismatches = 0
    toks = iter(table.read().split())
    hi = ped.chromstarts[1]
    block = 0
    try:
        while True:
            block += 1
            for n in ped.dous:
                name = next(toks)
                while name == "--":
                    name = next(toks)
                ind = ped.by_id(n)
                mismatches += _compare_one(ped, ind, toks, hi, block, out)
    except StopIteration:
        pass
    return mismatches


def _compare_one(ped, ind, toks, hi, block, out) -> int:
    mismatches = 0
    for i in range(hi):
        vals = []
        for _ in range(3):
            t = next(toks)
            try:
                vals.append(float(t))
            except ValueError:
                vals.append(-1.0)
        maxval = int(np.argmax(vals))
        data = int(ind.markerdata[i, 0] == 2) + \
            int(ind.markerdata[i, 1] == 2)
        p0 = ped.by_id(ind.pars[0]) if ind.pars[0] else None
        p1 = ped.by_id(ind.pars[1]) if ind.pars[1] else None
        if maxval != data and p0 and not p0.empty and p1 \
                and not p1.empty and i != hi - 1 \
                and vals[maxval] >= 0 \
                and ind.markerdata[i, 0] != UNKNOWN:
            mismatches += 1
            out.write(f"{ind.name} {block}:{i} {data}\t"
                      + "\t".join(str(v) for v in vals) + "\n")
    return mismatches
