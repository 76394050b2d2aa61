"""PlantImpute (AlphaImpute-style) input format.

The port's copy of ``cnf2freq_tpu/io/alpha.py`` (numpy only), building
the port's ``Pedigree``.  The ``.gen`` reader runs the native parser
(``native/genread.cc``) on a path; the Python reader runs only when the
caller asks for it (``use_native=False``).

Readers for the reference's native demo path (``readalphamap`` /
``readalphaped`` / ``readalphadata``; cnF2freq.cpp:6495-6685):

* map: one cM position per line; a position lower than its predecessor
  starts a new chromosome.
* ped: ``<ind> <father> <mother> [generation]``; generation >= 2 with
  founder (gen-0) parents synthesises an implicit F1 pair so the focal
  individual has a full 3-generation unit.
* gen: ``<ind> <g_1> ... <g_M>`` with g in {0,1,2,9} allele counts or
  ``a/b`` read-count pairs folded into per-allele error probabilities via a
  binomial model.
"""

from __future__ import annotations

import math
import os
from typing import Iterable, TextIO, Union

import numpy as np

from ..config import SEXMARKER, UNKNOWN
from ..pedigree import Pedigree

Source = Union[str, TextIO]


def _tokens(src: Source) -> Iterable[str]:
    close = False
    if isinstance(src, str):
        src = open(src, "rt")
        close = True
    try:
        for line in src:
            yield from line.split()
    finally:
        if close:
            src.close()


def _lines(src: Source):
    close = False
    if isinstance(src, str):
        src = open(src, "rt")
        close = True
    try:
        for line in src:
            if line.strip():
                yield line.split()
    finally:
        if close:
            src.close()


def read_alpha_map(ped: Pedigree, src: Source):
    """cnF2freq.cpp:6669-6685."""
    poses = []
    starts = []
    prev = 1e30
    for tok in _tokens(src):
        val = float(tok)
        if val < prev:
            starts.append(len(poses))
        poses.append(val)
        prev = val
    starts.append(len(poses))
    ped.markerposes = np.asarray(poses)
    ped.chromstarts = starts


def read_alpha_ped(ped: Pedigree, src: Source):
    """cnF2freq.cpp:6495-6540, including implicit-F1 synthesis."""
    for parts in _lines(src):
        if len(parts) < 3:
            continue
        me, father, mother = parts[:3]
        gen = 0
        if len(parts) >= 4:
            try:
                gen = int(parts[3])
            except ValueError:
                gen = 0
        ime = ped.getind(me)
        ifa = ped.getind(father)
        imo = ped.getind(mother)
        # every individual named in the ped file starts out empty until
        # genotype data shows up (cnF2freq.cpp:6511-6513)
        for i in (ime, ifa, imo):
            if i is not None:
                i.empty = True
        if gen >= 2 and ifa is not None and imo is not None \
                and ifa.gen == 0 and imo.gen == 0:
            # founders listed as direct parents of a gen>=2 individual:
            # synthesise the intervening F1 pair (cnF2freq.cpp:6515-6527)
            aux = [ped.getind(me + "_aux_realf"), ped.getind(me + "_aux_realm")]
            for a in aux:
                a.gen = 1
                a.pars = (ifa.n, imo.n)
                a.empty = True
            ime.pars = (aux[0].n, aux[1].n)
            ime.gen = gen
        else:
            ime.gen = gen
            ime.pars = (ifa.n if ifa else 0, imo.n if imo else 0)
        if gen >= 2:
            ped.dous.append(ime.n)


def _readcount_error(data: int, data2: int):
    """Binomial read-count model (cnF2freq.cpp:6599-6639): expected
    per-allele error probabilities for ``data`` reads of allele 1 and
    ``data2`` reads of allele 2."""
    def binom_pdf(n, k):
        return math.comb(n, k) * (0.5 ** n)

    sure1 = sure2 = probsum = 0.0
    for rl1 in range(data + 1):
        for rl2 in range(data2 + 1):
            l1, l2 = rl1, rl2
            overall = (binom_pdf(data, l1) if data else 1.0) * \
                      (binom_pdf(data2, l2) if data2 else 1.0)
            while True:
                sb1 = 0.5
                sb2 = 0.5
                if l1 + l2:
                    sb1 = l1 / (l1 + l2)
                if data + data2 - l1 - l2:
                    sb2 = (data2 - l2) / (data + data2 - l1 - l2)
                if sb1 + 1e-9 > 1 - sb2:
                    break
                l1 = data - l1
                l2 = data2 - l2
            overall *= (sb1 ** l1) * ((1 - sb1) ** l2) * \
                       (sb2 ** (data2 - l2)) * ((1 - sb2) ** (data - l1))
            sure1 += sb1 * overall
            sure2 += sb2 * overall
            probsum += overall
    return sure1 / probsum, sure2 / probsum


def read_alpha_data(ped: Pedigree, src: Source, genotype_error: float = 0.02,
                    use_native: bool = True):
    """cnF2freq.cpp:6542-6667.

    Requires the map to be read first.  Allocates marker arrays.
    use_native: parse the file with the C++ parser (native/genread.cc;
    identical output, ~50x the row rate at cohort scale), which takes a
    path; a stream needs ``use_native=False``, the Python reader.  A
    failed build of the parser raises."""
    m = ped.num_markers
    ped.freeze()
    if use_native:
        if not isinstance(src, (str, os.PathLike)):
            raise TypeError("the native .gen reader takes a path; pass "
                            "use_native=False to read a stream")
        from ..native import parse_gen_native
        _apply_gen_rows(ped, *parse_gen_native(os.fspath(src), m,
                                               genotype_error))
        return
    # the "haplo" pseudo-parent for doubled haploids (cnF2freq.cpp:6544-6549)
    haplo = ped.getind("haplo", create=False)
    toks = _tokens(src)
    while True:
        try:
            name = next(toks)
        except StopIteration:
            break
        ime = ped.getind(name)
        if ime.markerdata is None:
            ped.freeze()
        doublehaplo = haplo is not None and ime.pars[1] == haplo.n
        ime.empty = False
        for x in range(m):
            try:
                tok = next(toks)
            except StopIteration:
                raise ValueError(
                    f"genotype file ended mid-row: individual {name!r} has "
                    f"{x} of {m} marker columns") from None
            ime.haploweight[x] = 0.5
            if "/" not in tok:
                data = int(tok)
                pairs = {0: (1, 1), 1: (1, 2), 2: (2, 2)}
                pair = pairs.get(data, (UNKNOWN, UNKNOWN))
                ime.markerdata[x] = pair
                if pair[0] != UNKNOWN:
                    ime.markersure[x] = (genotype_error, genotype_error)
            else:
                data, data2 = (int(v) for v in tok.split("/"))
                if data == 0 and data2 == 0:
                    ime.markerdata[x] = (UNKNOWN, UNKNOWN)
                    ime.markersure[x] = (0.0, 0.0)
                else:
                    sure1, sure2 = _readcount_error(data, data2)
                    marker = [2, 1]
                    sure = [sure1, sure2]
                    for k in range(2):
                        if sure[k] > 0.5:   # invert implausible error rates
                            sure[k] = 1 - sure[k]
                            marker[k] = k + 1
                    ime.markerdata[x] = marker
                    ime.markersure[x] = sure
                if doublehaplo:
                    ime.markerdata[x][1] = SEXMARKER
        ime.priormarkerdata = ime.markerdata.copy()
        ime.priormarkersure = ime.markersure.copy()
        ime.has_prior = True


def _apply_gen_rows(ped: Pedigree, names, md, ms, rc):
    """Assign natively parsed rows, applying the pedigree-dependent
    pieces the parser can't know: doubled-haploid sexmarkers and the
    prior snapshot (cnF2freq.cpp:6544-6549, 6660-6665)."""
    haplo = ped.getind("haplo", create=False)
    for i, name in enumerate(names):
        ime = ped.getind(name)
        if ime.markerdata is None:
            ped.freeze()
        ime.empty = False
        ime.haploweight[:] = 0.5
        ime.markerdata[:] = md[i]
        ime.markersure[:] = ms[i]
        if haplo is not None and ime.pars[1] == haplo.n:
            ime.markerdata[rc[i], 1] = SEXMARKER
        ime.priormarkerdata = ime.markerdata.copy()
        ime.priormarkersure = ime.markersure.copy()
        ime.has_prior = True


def load_plantimpute(mapfile: Source, pedfile: Source, genfile: Source,
                     config=None, use_native: bool = True) -> Pedigree:
    """Convenience wrapper for the demo path (demo.sh:37)."""
    ped = Pedigree(config)
    read_alpha_map(ped, mapfile)
    read_alpha_ped(ped, pedfile)
    read_alpha_data(ped, genfile, use_native=use_native)
    return ped
