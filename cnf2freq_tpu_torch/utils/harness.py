"""Mask-impute-compare research harness.

The port's copy of ``cnf2freq_tpu/utils/harness.py`` (numpy only); its
``run_experiment`` builds the port's ``Driver``, which runs on the card
unless ``device="cpu"`` is passed.

The reference's QTLMAS loaders (``readqtlmas``/``readqtlmas14``,
cnF2freq.cpp:2517-2748) are hard-coded impute-and-compare experiments on
private workshop datasets: they blank deliberate marker subsets
(``i % 10``, cnF2freq.cpp:2610-2614) and let the run recover them.  This
module is the general, dataset-independent form of that harness: mask a
configurable subset of (individual, marker) genotypes, run the driver,
score recovery against the held-back truth.  Combined with
``utils.simulate.simulate_f2`` it replaces the private datasets with
reproducible synthetic cohorts; it works equally on any loaded pedigree
(the ``--clear``/``--impoutput`` CLI flow wraps the same idea for files,
io/masking.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import UNKNOWN
from ..pedigree import Pedigree


@dataclasses.dataclass
class MaskResult:
    masked: List[Tuple[int, int]]         # (individual id, marker)
    truth: Dict[Tuple[int, int], Tuple[int, int]]


def mask_markers(ped: Pedigree, every: int = 10, phase: int = 0,
                 individuals: Optional[Sequence[int]] = None) -> MaskResult:
    """Blank every ``every``-th marker (offset ``phase``) for the given
    individuals (default: the analysis worklist) — the clean form of
    readqtlmas's masking (cnF2freq.cpp:2610-2614).  Returns the held-back
    truth for scoring."""
    ids = list(individuals) if individuals is not None else list(ped.dous)
    masked, truth = [], {}
    for n in ids:
        ind = ped.by_id(n)
        for m in range(phase, ped.num_markers, every):
            a, b = int(ind.markerdata[m, 0]), int(ind.markerdata[m, 1])
            if a == UNKNOWN and b == UNKNOWN:
                continue
            truth[(n, m)] = (a, b)
            masked.append((n, m))
            ind.markerdata[m] = (UNKNOWN, UNKNOWN)
            ind.markersure[m] = (0.0, 0.0)
            if ind.has_prior:
                # the reference's masking blanks the prior too
                # (clearunprotected, cnF2freq.cpp:7563-7564); keeping it
                # would leak the held-out observation into the
                # imputation prior term
                ind.priormarkerdata[m] = (UNKNOWN, UNKNOWN)
                ind.priormarkersure[m] = (0.0, 0.0)
    return MaskResult(masked=masked, truth=truth)


def score_recovery(ped: Pedigree, res: MaskResult,
                   sure_threshold: float = 0.2) -> Dict[str, float]:
    """Compare imputed ``markerdata`` against the held-back truth.

    A site counts as *called* when both alleles are non-unknown with
    error probability below ``sure_threshold``; a called site is
    *correct* when the unordered allele pair matches the truth."""
    called = correct = 0
    per_site = []
    for (n, m), (ta, tb) in res.truth.items():
        ind = ped.by_id(n)
        a, b = int(ind.markerdata[m, 0]), int(ind.markerdata[m, 1])
        sa, sb = float(ind.markersure[m, 0]), float(ind.markersure[m, 1])
        is_called = (a != UNKNOWN and b != UNKNOWN and
                     max(sa, sb) < sure_threshold)
        ok = is_called and sorted((a, b)) == sorted((ta, tb))
        called += is_called
        correct += ok
        per_site.append((n, m, is_called, ok))
    total = len(res.truth)
    return dict(total=total, called=called, correct=correct,
                call_rate=called / total if total else 0.0,
                accuracy=correct / called if called else 0.0)


def run_experiment(ped: Pedigree, every: int = 10, iterations: int = 4,
                   driver=None, **driver_kw) -> Dict[str, float]:
    """The full readqtlmas-style experiment on a loaded pedigree: mask,
    preprocess, iterate, score."""
    from ..driver import Driver
    res = mask_markers(ped, every=every)
    drv = driver or Driver(ped, **driver_kw)
    drv.preprocess()
    for i in range(iterations):
        if i == 0:
            drv.iterate(early=True)
        else:
            drv.iterate()
    out = score_recovery(ped, res)
    # majority-confidence companion metrics: without priors at held-out
    # sites the capped-GD entropy term equilibrates markersure around
    # 0.2-0.35 (the reference's processinfprobs does the same,
    # cnF2freq.cpp:4268-4295), so the strict 0.2-threshold call rate
    # under-reports genuine recovery
    maj = score_recovery(ped, res, sure_threshold=0.5)
    out["majority_call_rate"] = maj["call_rate"]
    out["majority_accuracy"] = maj["accuracy"]
    out["iterations"] = iterations
    return out
