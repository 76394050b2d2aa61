"""PLINK .fam/.bed reader.

The port's copy of ``cnf2freq_tpu/io/plink.py`` (numpy only), reading
and writing the port's ``Pedigree``.

The reference memory-maps the 2-bit SNP-major .bed and bumps prior
uncertainty where it disagrees with (or is missing against) the haps-based
data (``readfambed``, cnF2freq.cpp:7332-7447).  numpy memmap equivalent.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from ..config import UNKNOWN
from ..pedigree import Pedigree

_BED_MAGIC = b"\x6c\x1b\x01"


def read_fam(src: Union[str]) -> dict:
    """name -> column index in the bed file."""
    out = {}
    with open(src) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[1] not in out:
                out[parts[1]] = len(out)
    return out


def read_fam_bed(ped: Pedigree, famfile: str, bedfile: str,
                 dooverwrite: bool = False):
    """Cross-check current genotypes against the PLINK truth: on
    disagreement or missingness, bump the prior uncertainty
    (0.5 * (0.5 + prior)); with dooverwrite also replace markerdata."""
    ind_nums = read_fam(famfile)
    n_ind = len(ind_nums)
    blocksize = (n_ind + 3) // 4
    raw = np.memmap(bedfile, dtype=np.uint8, mode="r")
    assert bytes(raw[:3]) == _BED_MAGIC, "not a SNP-major PLINK bed file"
    snps = raw[3:]
    map_indices = getattr(ped, "map_indices",
                          list(range(ped.num_markers)))
    monomorphs = getattr(ped, "hapmonomorphs", [False] * ped.num_markers)

    changed = 0
    for n in ped.dous:
        ind = ped.by_id(n)
        if ind.name not in ind_nums:
            continue
        index = ind_nums[ind.name]
        byte_off = index // 4
        shift = 2 * (index % 4)
        for i in range(ped.num_markers):
            block = snps[map_indices[i] * blocksize + byte_off]
            val = (int(block) >> shift) & 3
            if val == 0:
                marker = (1, 1)
            elif val == 1:
                marker = (UNKNOWN, UNKNOWN)
            elif val == 2:
                marker = (1, 2)
            else:
                # ShapeIT turns A A into 0 A: monomorphic sites read as
                # hom-second-allele (cnF2freq.cpp:7402-7407)
                v = 2 - int(monomorphs[i])
                marker = (v, v)
            prior = tuple(ind.priormarkerdata[i]) if ind.has_prior else \
                (UNKNOWN, UNKNOWN)
            if val == 0 or val == 3:
                isachange = marker != prior
            elif val == 2:
                isachange = prior[0] == prior[1]
            else:
                isachange = False
            if isachange or marker[0] == UNKNOWN:
                changed += 1
                if ind.has_prior:
                    ind.priormarkersure[i] = 0.5 * (
                        0.5 + ind.priormarkersure[i])
                if dooverwrite:
                    ind.markerdata[i] = marker
    return changed


def write_fam_bed(ped: Pedigree, famfile: str, bedfile: str,
                  ids: Sequence[int] = None):
    """Export current genotypes as PLINK fam/bed (round-trip utility)."""
    ids = list(ids if ids is not None else ped.dous)
    with open(famfile, "w") as f:
        for n in ids:
            ind = ped.by_id(n)
            f.write(f"1 {ind.name} 0 0 {ind.sex + 1} -9\n")
    n_ind = len(ids)
    blocksize = (n_ind + 3) // 4
    M = ped.num_markers
    out = np.zeros(3 + M * blocksize, dtype=np.uint8)
    out[:3] = np.frombuffer(_BED_MAGIC, dtype=np.uint8)
    for i in range(M):
        for j, n in enumerate(ids):
            md = ped.by_id(n).markerdata[i]
            a2 = int(md[0] == 2) + int(md[1] == 2)
            if md[0] == UNKNOWN and md[1] == UNKNOWN:
                code = 1
            elif a2 == 0:
                code = 0
            elif a2 == 1:
                code = 2
            else:
                code = 3
            out[3 + i * blocksize + j // 4] |= code << (2 * (j % 4))
    out.tofile(bedfile)
