"""ccoeff-style F2 input format.

The port's copy of ``cnf2freq_tpu/io/ccoeff.py`` (numpy only), building
the port's ``Pedigree``.

The reference's original QTL-analysis input: a marker-info file with
per-chromosome marker lists and per-sex map halves, a pedigree of full
sibships headed by four founders and two parents, and a genotype table
(``readmarkerinfo``/``readped``/``readmarkerdata``,
cnF2freq.cpp:2752-2916).
"""

from __future__ import annotations

from typing import Union, TextIO

import numpy as np

from ..config import RuntimeParams
from ..pedigree import Pedigree
from .alpha import _tokens

Source = Union[str, TextIO]


def read_marker_info(ped: Pedigree, src: Source,
                     params: RuntimeParams = None):
    """Map + marker-translation reader (cnF2freq.cpp:2752-2832).

    Layout: ``nchrom  nmarkers_total`` then per chromosome a count and the
    global marker numbers on it; then per chromosome, per sex, a label and
    per-marker interval distances (summed into positions; sexes averaged).
    """
    params = params or RuntimeParams()
    toks = _tokens(src)
    n = int(next(toks))
    m = int(next(toks))
    ped.markertranslation = np.zeros(m, dtype=np.int32)
    counts = []
    j = 0
    for i in range(n):
        c = int(next(toks))
        counts.append(c)
        for _ in range(c):
            idx = int(next(toks))
            j += 1
            ped.markertranslation[idx - 1] = j

    poses = []
    starts = []
    actrec = [[], []]
    sexc = params.sexc
    pos = 0
    for i in range(n):
        starts.append(pos)
        part = [[], []]
        for t in range(sexc):
            next(toks)  # per-half label/count
            acc = 0.0
            for _ in range(counts[i]):
                acc += float(next(toks))
                for p in range(2 // sexc):
                    part[t + p].append(acc / params.discstep)
        for k in range(counts[i]):
            avg = (part[0][k] + part[1][k]) / 2.0
            poses.append(avg)
            for t in range(2):
                if k and avg - poses[pos - 1] != 0:
                    actrec[t].append(params.baserec *
                                     (part[t][k] - part[t][k - 1]) /
                                     (poses[pos] - poses[pos - 1]))
                else:
                    actrec[t].append(-1.0)
            pos += 1
    starts.append(pos)
    ped.markerposes = np.asarray(poses)
    ped.chromstarts = starts
    ped.actrec = np.asarray(actrec)


def read_ped(ped: Pedigree, src: Source):
    """Full-sibship pedigree blocks: 4 founders, 2 parents, famsize F2s
    (cnF2freq.cpp:2835-2878)."""
    toks = _tokens(src)
    while True:
        try:
            famsize = int(next(toks))
        except StopIteration:
            break
        for i in range(famsize + 6):
            indn = int(next(toks))
            fa = int(next(toks))
            mo = int(next(toks))
            sex = int(next(toks))
            strain = int(next(toks))
            ind = ped.getind(str(indn))
            pfa = ped.getind(str(fa)) if fa else None
            pmo = ped.getind(str(mo)) if mo else None
            # mother first; swap if sexes say otherwise
            p0, p1 = pmo, pfa
            if p0 and p1 and p0.sex == 1 and p1.sex == 0:
                p0, p1 = p1, p0
            ind.pars = (p0.n if p0 else 0, p1.n if p1 else 0)
            ind.sex = sex - 1
            ind.strain = strain
            ind.gen = (1 if i >= 4 else 0) + (1 if i >= 6 else 0)
            ind.empty = False
            if i >= 6:
                ped.dous.append(ind.n)


def read_marker_data(ped: Pedigree, src: Source,
                     genotype_error: float = 0.0):
    """Genotype table keyed by individual number, columns in original
    marker numbering remapped through markertranslation
    (cnF2freq.cpp:2882-2916)."""
    ped.freeze()
    trans = ped.markertranslation
    toks = _tokens(src)
    while True:
        try:
            indn = int(next(toks))
        except StopIteration:
            break
        ind = ped.getind(str(indn))
        if ind.markerdata is None:
            ped.freeze()
        ind.empty = False
        for i in range(len(trans)):
            a = int(next(toks))
            b = int(next(toks))
            if trans[i]:
                ind.markerdata[trans[i] - 1] = (a, b)
                if genotype_error:
                    ind.markersure[trans[i] - 1] = (
                        genotype_error if a else 0.0,
                        genotype_error if b else 0.0)


def load_ccoeff(markerinfo: Source, pedfile: Source, genofile: Source,
                config=None, params: RuntimeParams = None) -> Pedigree:
    ped = Pedigree(config)
    read_marker_info(ped, markerinfo, params)
    read_ped(ped, pedfile)
    read_marker_data(ped, genofile)
    return ped
