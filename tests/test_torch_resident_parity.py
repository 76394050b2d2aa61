"""The port's default Driver (the device-resident iteration) against the
JAX package's Driver on its resident iteration (``resident=True``).

simulate_f2(n_f2=12, n_markers=16) in float64 with adaptive relhaplo (the
default), each package through its own preprocess and three iterations,
the port's three rules patched into the JAX Driver
(``torch_port_util.run_pair``, as in tests/test_torch_driver.py, whose
JAX Driver runs its host-accumulator iteration).  On its resident
iteration the JAX Driver hands the flip scorer device views of its
accumulators and mirrors; the patched scorer takes them as it takes host
arrays.  The final haploweights, markerdata/markersure, relhaplo and pair
tables agree at rtol 1e-8, iteration by iteration, and every choice in
which a port rule departs from the JAX package's is bounded as there.
Each Driver carries its package's ``Tracer``: the port's ``iteration``
records (one an iteration) have the JAX records' keys and values, and its
span paths include the stages the JAX test of the tracer names.
"""
import pytest
from torch_port_util import check_anchor_departures, check_iterations, run_pair

from cnf2freq_tpu.utils import simulate_f2


@pytest.fixture(scope="module")
def runs():
    return run_pair(simulate_f2(n_f2=12, n_markers=16), adaptive=True,
                    jax_resident=True)


def test_resident_iterations_match(runs):
    check_iterations(runs, ("haploweight", "markersure", "relhaplo"))
    assert (runs["torch"]["post"]["relhaplo"] != 0.5).any()


def test_resident_departures(runs):
    check_anchor_departures(runs["seen"]["anchors"])
    assert runs["seen"]["winners"]  # the flip solve ran
    assert sum(runs["seen"]["winners"]) <= 1


def test_iteration_records_match(runs):
    recs = {k: [{f: v for f, v in m.items() if f != "t"}
                for m in runs[k]["metrics"] if m.get("event") == "iteration"]
            for k in ("jax", "torch")}
    assert len(recs["torch"]) == len(runs["torch"]["iters"]) == 3
    assert [r["iter"] for r in recs["torch"]] == [1, 2, 3]
    for a, b in zip(recs["torch"], recs["jax"]):
        assert a.keys() == b.keys() == {"type", "event", "iter", "hitnnn",
                                        "inverted", "scalefactor", "flips"}
        assert a["scalefactor"] == pytest.approx(b["scalefactor"], rel=1e-12)
        assert {k: v for k, v in a.items() if k != "scalefactor"} == \
            {k: v for k, v in b.items() if k != "scalefactor"}
    spans = runs["torch"]["spans"]
    assert "preprocess" in spans
    assert any(k.endswith("scan") for k in spans)
    assert any(k.endswith("updates") for k in spans)
