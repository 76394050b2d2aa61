"""Phased-genotype VCF output by template rewrite (``outputvcf``,
cnF2freq.cpp:7863-7912; compiled out of the reference by default,
settings.h:6).

The port's copy of ``cnf2freq_tpu/io/vcf.py`` (no JAX, no import of
the JAX package), reading the port's ``Pedigree``.

The reference reads a template VCF via libStatGen and rewrites each
record's per-sample GT as the phased pair ``a|b`` with allele number
``int(markerval != refnum)``, strand order swapped when
``haploweight > 0.5``.  This implementation is self-contained text
parsing: header lines pass through, records are matched to markers by the
ID column, and only the GT subfield is rewritten.  ``.gz`` paths are
handled transparently on both ends.
"""

from __future__ import annotations

import gzip
from typing import IO, Union

from ..config import UNKNOWN
from ..pedigree import Pedigree

Source = Union[str, IO]


def _open(path_or_file, mode: str):
    if not isinstance(path_or_file, str):
        return path_or_file, False
    if path_or_file.endswith(".gz"):
        return gzip.open(path_or_file, mode + "t"), True
    return open(path_or_file, mode), True


def _gt_str(val: int, refnum: int) -> str:
    if val == UNKNOWN:
        return "."
    return str(int(val != refnum))


def output_vcf(ped: Pedigree, template: Source, out: Source):
    """Rewrite ``template``'s GT fields from the pedigree's (possibly
    imputed) ``markerdata``/``haploweight`` and write to ``out``."""
    fin, close_in = _open(template, "r")
    fout, close_out = _open(out, "w")
    try:
        samples = None
        inds = None
        for line in fin:
            line = line.rstrip("\n")
            if line.startswith("##") or not line:
                fout.write(line + "\n")
                continue
            if line.startswith("#CHROM"):
                cols = line.split("\t")
                samples = cols[9:]
                inds = []
                for s in samples:
                    ind = ped.getind(s, create=False)
                    if ind is None and len(s) > 2:
                        # the reference strips an extra "1_" family prefix
                        # (cnF2freq.cpp:7885)
                        ind = ped.getind(s[2:], create=False)
                    if ind is None:
                        raise KeyError(f"VCF sample {s!r} not in pedigree")
                    inds.append(ind)
                fout.write(line + "\n")
                continue
            if samples is None:
                raise ValueError("VCF data before #CHROM header line")
            cols = line.split("\t")
            marker_id = cols[2]
            if marker_id not in ped.markernames:
                raise KeyError(f"VCF record ID {marker_id!r} has no marker")
            pos = ped.markernames[marker_id]
            refnum = int(cols[3])
            fmt = cols[8].split(":")
            gt_i = fmt.index("GT")
            for i, ind in enumerate(inds):
                a, b = int(ind.markerdata[pos, 0]), int(ind.markerdata[pos, 1])
                if ind.haploweight is not None and \
                        ind.haploweight[pos] > 0.5:
                    a, b = b, a
                sub = cols[9 + i].split(":")
                sub[gt_i] = _gt_str(a, refnum) + "|" + _gt_str(b, refnum)
                cols[9 + i] = ":".join(sub)
            fout.write("\t".join(cols) + "\n")
    finally:
        if close_in:
            fin.close()
        if close_out:
            fout.close()
