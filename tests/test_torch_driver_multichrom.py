"""The port's Driver against the JAX package's Driver on two chromosomes.

simulate_f2(n_f2=12, n_markers=8, n_chromosomes=2) in float64: each
package through its own preprocess and three iterations with adaptive
relhaplo (the default: the classic pipeline with coherence), the port's
three rules patched into the JAX Driver (``torch_port_util.run_pair``, as
in tests/test_torch_driver.py).  The final haploweights,
markerdata/markersure, relhaplo and pair tables agree at rtol 1e-8,
iteration by iteration.  The same cohort with adaptive relhaplo off
would double the file's cost (about 45 s on one CPU core for both), so
only the default runs here; tests/test_torch_driver.py holds both
settings on one chromosome.

Each anchor on which the port's rule departs from the JAX package's
choice is checked on its own: the JAX package's anchor ties the largest
variance up to LOCK_TIE_RTOL, or the chromosome's variances are all
rounding residue.  No count is bounded: on two chromosomes most
departures are exact variance ties between markers (a tie the JAX
package breaks by rounding), so their number says nothing about the
rule.
"""
import pytest
from torch_port_util import check_anchor_departures, check_iterations, run_pair

from cnf2freq_tpu.utils import simulate_f2


@pytest.fixture(scope="module")
def runs():
    base = simulate_f2(n_f2=12, n_markers=8, n_chromosomes=2)
    assert base.num_chromosomes == 2
    return run_pair(base, adaptive=True)


def test_two_chromosomes_match(runs):
    check_iterations(runs, ("haploweight", "markersure", "relhaplo"))
    assert (runs["torch"]["post"]["relhaplo"] != 0.5).any()


def test_two_chromosome_anchor_departures(runs):
    check_anchor_departures(runs["seen"]["anchors"])
    assert runs["seen"]["anchors"]  # the tie rule was exercised
    assert runs["seen"]["winners"]  # the flip solve ran
