"""Output writers and checkpoint/restart.

The port's copy of ``cnf2freq_tpu/io/outputs.py`` (numpy only): the same
text for the same pedigree and tables.

* genotype-probability table — the PlantImpute output contract: per imputed
  individual, one row per marker with P(11) P(12) P(21) P(22)
  (demo.sh:30-31, demooutput format)
* haplotype dump — the per-iteration state dump that doubles as the
  checkpoint (cnF2freq.cpp:8157-8194)
* deserialize — restore from a dump, with phase-switch accounting
  (cnF2freq.cpp:7757-7832)
* outputped — PLINK-ish ped export with phase-sorted alleles
  (cnF2freq.cpp:7846-7861)
"""

from __future__ import annotations

import itertools
from typing import Dict, TextIO

import numpy as np

from ..pedigree import Pedigree


def write_genotype_table(ped: Pedigree, pair_tables: Dict[int, np.ndarray],
                         out: TextIO, phased: bool = False,
                         include_all: bool = False):
    """Per imputed individual and chromosome: genotype-class posteriors.

    Default layout matches the PlantImpute output artifact
    (``demooutput``): P(no allele-2), P(one), P(both), and a vestigial
    always-zero 4th column (the reference's genotypereporter has 3
    classes; the documented 11/12/21/22 header is the workflow's
    description of them, demo.sh:30-31).  ``phased=True`` instead emits
    the full ordered posteriors P(11) P(12) P(21) P(22) this engine
    actually computes.

    By default a block is written only when every parental line of the
    analysis unit carries genotype data (the parent itself or one of its
    parents is non-``empty``) — the reference artifact's block set:
    ``demooutput`` has C and D (aux parents backed by genotyped founders
    A, B) but not F, whose parent H never appears in the .gen file.
    The rule is a heuristic inferred from that one artifact (the
    reference's own reporter is commented out at HEAD,
    cnF2freq.cpp:5553/5873, so no second golden exists); skipped blocks
    are therefore *counted and announced on stderr* so a silently
    dropped block is always visible.  ``include_all=True`` writes every
    ``dous`` member.  Returns the list of skipped individual names."""
    def _line_informative(pid: int) -> bool:
        par = ped.by_id(pid) if pid else None
        if par is None:
            return False
        if not par.empty:
            return True
        return any(gp and not ped.by_id(gp).empty for gp in par.pars)

    skipped = []
    for n in ped.dous:
        ind = ped.by_id(n)
        if not include_all and not all(_line_informative(p)
                                       for p in ind.pars):
            skipped.append(ind.name)
            continue
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            out.write(f"{ind.name}:{c + 1}\n")
            tab = pair_tables.get(n)
            if tab is None:
                rows = np.full((hi - lo, 4), 0.25)
            else:
                p = tab[lo:hi].reshape(hi - lo, 4)
                s = p.sum(axis=1, keepdims=True)
                pos = s > 0
                p = np.where(pos, p / np.where(pos, s, 1), 0.25)
                rows = p if phased else np.stack(
                    [p[:, 0], p[:, 1] + p[:, 2], p[:, 3],
                     np.zeros(hi - lo, p.dtype)], axis=1)
            _write_rows(out, rows)
            out.write("\n")
    if skipped:
        import sys
        print(f"genotype table: skipped {len(skipped)} block(s) with a "
              f"data-less parental line ({', '.join(skipped)}); pass "
              "include_all=True / --allblocks to emit them",
              file=sys.stderr)
    return skipped


def write_line_origin_table(ped: Pedigree, tables: Dict[int, np.ndarray],
                            out: TextIO):
    """Per analysis individual and chromosome: P(0), P(1), P(2) of the
    line-origin class — how many of the two strands trace to a founder
    '2' allele (the reference's gstr/mapval statistic, cnF2freq.cpp:5512,
    computed there but never reported)."""
    for n in ped.dous:
        ind = ped.by_id(n)
        tab = tables.get(n)
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            out.write(f"{ind.name}:{c + 1}\n")
            rows = tab[lo:hi] if tab is not None else \
                np.full((hi - lo, 3), 1.0 / 3)
            _write_rows(out, rows)


def write_haplotype_dump(ped: Pedigree, out: TextIO,
                         reset_negshift: bool = True, inds=None):
    """The reference's per-iteration dump (cnF2freq.cpp:8157-8194).

    inds: optional subset of individuals (sharded checkpoints)."""
    for ind in (ped.inds[1:] if inds is None else inds):
        if ind is None or ind.haploweight is None:
            continue
        out.write(f"{ind.n} {ind.name}\n")
        fmt = _DUMP_ROW + (_DUMP_PRIOR if ind.has_prior else "") + "\n"
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            rel = ind.relhaplo[lo:hi] if ind.relhaplo is not None else \
                np.zeros(hi - lo)
            md, ms = ind.markerdata[lo:hi], ind.markersure[lo:hi]
            cols = [ind.haploweight[lo:hi], _ints(md[:, 0]), _ints(md[:, 1]),
                    ind.negshift[lo:hi], ms[:, 0], ms[:, 1], rel]
            if ind.has_prior:
                pmd, pms = ind.priormarkerdata[lo:hi], \
                    ind.priormarkersure[lo:hi]
                cols += [_ints(pmd[:, 0]), _ints(pmd[:, 1]), pms[:, 0],
                         pms[:, 1]]
            _write_columns(out, fmt, cols)
            if reset_negshift:
                ind.negshift[lo:hi] = 0.0


# one dump row: haploweight, the two alleles, an empty column, negshift,
# the two markersure values and relhaplo; then the priors where present
_DUMP_ROW = "%f\t%d\t%d\t\t%f\t%.6f %.6f %.6f"
_DUMP_PRIOR = "\t%d\t%d\t%.6f\t%.6f"


def _ints(col):
    """Integer codes as Python ints (int() of each, as a row's f-string
    took them)."""
    return np.asarray(col).astype(np.int64)


def _write_columns(out: TextIO, fmt: str, cols):
    """Writes one line a row of the equal-length ``cols`` through the
    %-format ``fmt`` (one conversion a column), in one formatting call:
    the same text as formatting each value on its own, since tolist()
    gives the exact Python float or int of each element."""
    n = len(cols[0])
    if n:
        vals = tuple(itertools.chain.from_iterable(
            zip(*(np.asarray(c).tolist() for c in cols))))
        out.write((fmt * n) % vals)


def _write_rows(out: TextIO, rows):
    """A table's rows, each value to 5 decimals, tab-separated."""
    rows = np.asarray(rows)
    _write_columns(out, "\t".join(["%.5f"] * rows.shape[1]) + "\n",
                   [rows[:, k] for k in range(rows.shape[1])])


def deserialize(ped: Pedigree, stream: TextIO) -> Dict[int, int]:
    """Restore haploweight/markerdata/markersure from a dump; returns
    phase-switch counts per individual (cnF2freq.cpp:7757-7832)."""
    switches_out: Dict[int, int] = {}
    lines = iter(stream)
    M = ped.num_markers
    for line in lines:
        parts = line.split()
        if len(parts) != 2:
            continue
        try:
            n = int(parts[0])
        except ValueError:
            continue
        name = parts[1]
        ind = ped.by_id(n)
        indcheck = ped.getind(name, create=False)
        if ind is None or ind is not indcheck:
            continue
        oldphase = 0
        switches = 0
        for i in range(M):
            row = next(lines).split()
            hw = float(row[0])
            a, b = int(row[1]), int(row[2])
            s1, s2 = float(row[4]), float(row[5])
            inv = False
            match = True
            if (a, b) != tuple(ind.markerdata[i]):
                if (b, a) != tuple(ind.markerdata[i]):
                    match = False
                else:
                    inv = True
            ind.haploweight[i] = hw
            ind.markerdata[i] = (a, b)
            ind.markersure[i] = (s1, s2)
            # the dump's relhaplo column (the reference writes it too,
            # cnF2freq.cpp:8184, but never restores it — its PlantImpute
            # path leaves relhaplo inert): restoring it keeps the
            # adaptive-relhaplo trajectory continuous across
            # checkpoint/resume
            if len(row) >= 7 and ind.relhaplo is not None:
                ind.relhaplo[i] = float(row[6])
            if hw == 0.5 or a == b or not match:
                continue
            newphase = 1 + ((hw > 0.5) ^ inv)
            if oldphase and oldphase != newphase:
                switches += 1
            oldphase = newphase
        switches_out[n] = switches
    return switches_out


def output_ped(ped: Pedigree, filename: str):
    """cnF2freq.cpp:7846-7861."""
    def getname(n):
        ind = ped.by_id(n) if n else None
        return ind.name if ind else "0"

    with open(filename, "w") as f:
        for n in ped.dous:
            ind = ped.by_id(n)
            f.write(f"1 {ind.name} {getname(ind.pars[0])} "
                    f"{getname(ind.pars[1])} {ind.sex + 1} -9")
            for j in range(ped.num_markers):
                a, b = int(ind.markerdata[j, 0]), int(ind.markerdata[j, 1])
                if ind.haploweight[j] > 0.5:
                    a, b = b, a
                f.write(f" {a} {b}")
            f.write("\n")
