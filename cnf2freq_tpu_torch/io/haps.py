"""ShapeIT .sample/.bim/.haps ensemble readers.

The port's copy of ``cnf2freq_tpu/io/haps.py`` (numpy only), building
the port's ``Pedigree``.

The reference folds one maximum-realisation haps file plus any number of
posterior-sample haps files into marker data, haplotype weights, adjacent
phase coherence (relhaplo) and per-allele error probabilities
(``readhapsfull``/``readhapsonly``/``readFirstHaps``/``readOtherHaps``/
``initPadding``, cnF2freq.cpp:6837-7278).  Same semantics here, numpy
instead of Spirit X3.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, TextIO, Tuple, Union

import numpy as np

from ..config import UNKNOWN
from ..pedigree import Pedigree

Source = Union[str, TextIO]


def _read_lines(src: Source) -> List[List[str]]:
    close = isinstance(src, str)
    f = open(src) if close else src
    try:
        return [ln.split() for ln in f if ln.strip()]
    finally:
        if close:
            f.close()


def read_sample(src: Source) -> List[Tuple[str, str, str]]:
    """.sample file: two header lines then
    ``fam id missing father mother sex pheno`` rows -> (id, father,
    mother) triples (samplesRule, cnF2freq.cpp:6859-6866)."""
    rows = _read_lines(src)[2:]
    out = []
    for r in rows:
        if len(r) >= 5:
            out.append((r[1], r[3], r[4]))
    return out


@dataclasses.dataclass
class HapsData:
    chrom: List[int]
    name: List[str]
    allele1: List[str]
    allele2: List[str]
    haps: np.ndarray          # [M, 2*N] int


def read_haps(src: Source) -> HapsData:
    """.haps rows: ``chrom name pos a1 a2 h h ...``
    (hapsLine, cnF2freq.cpp:6856)."""
    rows = _read_lines(src)
    chrom, name, a1, a2, haps = [], [], [], [], []
    for r in rows:
        chrom.append(int(r[0]))
        name.append(r[1])
        a1.append(r[3])
        a2.append(r[4])
        haps.append([int(x) for x in r[5:]])
    return HapsData(chrom=chrom, name=name, allele1=a1, allele2=a2,
                    haps=np.asarray(haps, dtype=np.int32))


def read_bim(src: Source):
    """(chrom, name) -> (bp position, index) (cnF2freq.cpp:7090-7103)."""
    gene_map = {}
    for r in _read_lines(src):
        # chrom name cM bp a1 a2
        gene_map[(int(r[0]), r[1])] = (int(r[3]), len(gene_map))
    return gene_map


def _mv_from_index(hd: HapsData, hapval: int, snp: int) -> int:
    return hapval + 1


def _mv_from_alleles(hd: HapsData, hapval: int, snp: int) -> int:
    # the reference maps the first allele character minus '0'
    # (cnF2freq.cpp:7200-7212); numeric alleles give 1/2, letters give
    # their faithful (if odd) char offsets
    a = hd.allele1[snp] if hapval == 0 else hd.allele2[snp]
    return ord(a[0]) - 48


def read_first_haps(ped: Pedigree, hd: HapsData, inds: Sequence[int],
                    dohaploweight, indexconv):
    """cnF2freq.cpp:6914-6952."""
    M = hd.haps.shape[0]
    for j, n in enumerate(inds):
        ind = ped.by_id(n)
        for i in range(M):
            straight = (indexconv(hd, hd.haps[i, 2 * j], i),
                        indexconv(hd, hd.haps[i, 2 * j + 1], i))
            flipped = (straight[1], straight[0])
            cur = tuple(ind.markerdata[i])
            if straight == cur or flipped == cur:
                ind.priormarkerdata[i] = straight
            ind.markerdata[i] = straight
            if dohaploweight(ind):
                ind.haploweight[i] = 1e-3
            ind.markersure[i] = (0.0, 0.0)
            if ped.config.relskews and i != M - 1:
                ind.relhaplo[i] = 0.5 + 0.5 * math.exp(
                    -(ped.markerposes[i + 1] - ped.markerposes[i]))


def init_padding(ped: Pedigree, inds: Sequence[int], count: int,
                 dohaploweight) -> float:
    """cnF2freq.cpp:7056-7075."""
    padding = 1e-2
    unit = 1.0 / (count + padding)
    for n in inds:
        ind = ped.by_id(n)
        if ped.config.relskews:
            ind.relhaplo[:] = unit
        if dohaploweight(ind):
            ind.haploweight[:] = unit * padding * 0.5
        ind.markersure[:] = padding * unit
    return unit


def read_other_haps(ped: Pedigree, hd: HapsData, inds: Sequence[int],
                    unit: float, genounit: float, dohaploweight, indexconv):
    """Fold one posterior haps sample into phase-switch and error
    frequencies (cnF2freq.cpp:6954-7054)."""
    M = hd.haps.shape[0]
    N = len(inds)

    def find_match(i, j, ind):
        straight = (indexconv(hd, hd.haps[i, 2 * j], i),
                    indexconv(hd, hd.haps[i, 2 * j + 1], i))
        flipped = (straight[1], straight[0])
        cur = tuple(ind.markerdata[i])
        match_num, num = 0, 0
        for p, mk in ((1, straight), (2, flipped)):
            if mk == cur:
                match_num = p
                num += 1
        return match_num, num

    orig = [0] * N
    phases = [0] * N
    for i in range(M):
        for j, n in enumerate(inds):
            if not orig[j]:
                mn, num = find_match(i, j, ped.by_id(n))
                if num == 1:
                    orig[j] = mn
                    phases[j] = mn
    for j in range(N):
        if not orig[j]:
            orig[j] = phases[j] = 1

    for i in range(M):
        for j, n in enumerate(inds):
            ind = ped.by_id(n)
            old = phases[j]
            mn, num = find_match(i, j, ind)
            if num in (0, 2):
                mn = old
            phases[j] = mn
            if dohaploweight(ind) and orig[j] != phases[j]:
                ind.haploweight[i] += unit
            if ped.config.relskews and i:
                ind.relhaplo[i - 1] += unit * float(old == 0 or
                                                   phases[j] == old)
            if not num:
                ms = [indexconv(hd, hd.haps[i, 2 * j], i),
                      indexconv(hd, hd.haps[i, 2 * j + 1], i)]
                if phases[j] == 2:
                    ms = ms[::-1]
                nomatch = [ms[p] != ind.markerdata[i, p] for p in range(2)]
                if not nomatch[0] and not nomatch[1]:
                    nomatch = [True, True]
                for p in range(2):
                    ind.markersure[i, p] = min(
                        ind.markersure[i, p] + genounit * nomatch[p],
                        1.0 - unit)


def read_haps_full(ped: Pedigree, samples: Sequence[Tuple[str, str, str]],
                   bim: Source, haps_files: Sequence[Source]):
    """The full --samplefile/--bimfile/--hapfiles ingestion
    (cnF2freq.cpp:7083-7190)."""
    gene_map = read_bim(bim)
    hd = read_haps(haps_files[0])
    poses, starts, map_indices, monomorphs = [], [], [], []
    lastchrom = None
    basepos = 0.0
    for i in range(len(hd.chrom)):
        bp, index = gene_map[(hd.chrom[i], hd.name[i])]
        pos = bp * 1e-6
        if hd.chrom[i] != lastchrom:
            starts.append(len(poses))
            basepos = pos
        poses.append(pos - basepos)
        map_indices.append(index)
        lastchrom = hd.chrom[i]
        monomorphs.append(hd.allele1[i] == hd.allele2[i])
    starts.append(len(poses))
    ped.markerposes = np.asarray(poses)
    ped.chromstarts = starts
    ped.map_indices = map_indices
    ped.hapmonomorphs = monomorphs
    ped.markernames = {hd.name[i]: i for i in range(len(hd.name))}

    names = {s[0] for s in samples}
    inds = []
    for sid, father, mother in samples:
        me = ped.getind(sid)
        me.sex = 0
        pf = ped.getind(father) if father in names else None
        pm = ped.getind(mother) if mother in names else None
        me.pars = (pf.n if pf else 0, pm.n if pm else 0)
        me.gen = 2 * int(bool(me.pars[0] or me.pars[1]))
        ped.dous.append(me.n)
        inds.append(me.n)
    ped.freeze()
    for n in inds:
        ind = ped.by_id(n)
        ind.empty = False
        ind.priormarkerdata = np.full((ped.num_markers, 2), UNKNOWN,
                                      dtype=np.int32)
        ind.priormarkersure = np.zeros((ped.num_markers, 2))
        ind.has_prior = True

    def dohaploweight(ind):
        return ind.gen < 2

    read_first_haps(ped, hd, inds, dohaploweight, _mv_from_index)
    unit = init_padding(ped, inds, len(haps_files), dohaploweight)
    for k in range(1, len(haps_files)):
        hdk = read_haps(haps_files[k])
        read_other_haps(ped, hdk, inds, unit, unit, dohaploweight,
                        _mv_from_index)
    for n in inds:
        ind = ped.by_id(n)
        ind.priormarkerdata = ind.markerdata.copy()
        ind.priormarkersure = ind.markersure.copy()
    return inds


def read_haps_only(ped: Pedigree, haps_files: Sequence[Source]):
    """--hapfiles without a sample file: fold ensembles onto the existing
    analysis individuals, alleles taken from the haps allele columns
    (cnF2freq.cpp:7192-7278)."""
    hd = read_haps(haps_files[0])

    def dohaploweight(ind):
        return True

    read_first_haps(ped, hd, ped.dous, dohaploweight, _mv_from_alleles)
    unit = init_padding(ped, ped.dous, len(haps_files), dohaploweight)
    for k in range(1, len(haps_files)):
        hdk = read_haps(haps_files[k])
        read_other_haps(ped, hdk, ped.dous, unit, unit, dohaploweight,
                        _mv_from_alleles)
    for n in ped.dous:
        ind = ped.by_id(n)
        if ind.priormarkerdata is None:
            continue
        blank = (ind.priormarkerdata == UNKNOWN).all(axis=1)
        ind.priormarkerdata[blank] = ind.markerdata[blank]
        ind.priormarkersure[blank] = ind.markersure[blank]


def create_hap_file(ped: Pedigree, samples: Sequence[Tuple[str, str, str]],
                    oldhaps: Source, out: TextIO):
    """Rewrite a haps file with phase corrected by the current haplotype
    weights (createhapfile, cnF2freq.cpp:7280-7330)."""
    hd = read_haps(oldhaps)
    inds = [ped.getind(s[0], create=False) for s in samples]
    for i in range(hd.haps.shape[0]):
        cols = [str(hd.chrom[i]), hd.name[i], "0", hd.allele1[i],
                hd.allele2[i]]
        for j, ind in enumerate(inds):
            h = [int(hd.haps[i, 2 * j]), int(hd.haps[i, 2 * j + 1])]
            if ind is not None and ind.haploweight is not None \
                    and ind.haploweight[i] > 0.5:
                h = h[::-1]
            cols.extend(str(x) for x in h)
        out.write(" ".join(cols) + "\n")
