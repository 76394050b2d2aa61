"""The port's ``Driver(mesh=...)`` on the two-generation family and with
map re-estimation, against the JAX package's
``Driver(mesh=make_mesh(2))`` on the same cohorts: the ng2 cohort of
tests/test_engine_ng2.py's mesh test (a sire, a dam and 8 full sibs) and
the map re-estimation cohort of tests/test_collective.py's.

Two ranks are spawned as in tests/test_torch_mesh.py (a gloo group of
tests/torch_mesh_worker.py processes on the CPU, no JAX there); the JAX
Driver runs in this process on two of the 8 virtual CPU devices, with
the port's rules (``patch_jax_with_port_rules``).  Tolerances: float64,
rtol 1e-9 and atol 1e-11, hit counts and inversions equal, and the ranks
bit-identical.
"""

import numpy as np
import pytest

import torch_mesh_worker as worker
from torch_mesh_worker import case_arrays, results
from torch_port_util import patch_jax_with_port_rules

RTOL, ATOL = 1e-9, 1e-11
CASES = {2: ["ng2", "remap"]}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    yield from worker.spawn_groups(CASES, tmp_path_factory.mktemp)


def jax_cohort(case):
    """The JAX package's (pedigree, Driver attributes, iterations) of a
    case of tests/torch_mesh_worker.py's ``cohort``."""
    if case == "ng2":
        return worker.ng2_cohort(8, "cnf2freq_tpu"), {}, 2
    from cnf2freq_tpu.utils.simulate import simulate_f2
    return (simulate_f2(n_f2=16, n_markers=12, n_founder_pairs=2, seed=17),
            dict(remap_distances=True, adaptive_relhaplo=False), 2)


@pytest.mark.parametrize("case", CASES[2])
def test_mesh_driver_matches_jax_mesh(groups, case):
    from cnf2freq_tpu.driver import Driver as JaxDriver
    from cnf2freq_tpu.parallel import make_mesh as jax_mesh

    ped, attrs, iters = jax_cohort(case)
    seen = {"anchors": [], "winners": [], "flat": [], "scored": [],
            "negshift_ties": []}
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_with_port_rules(mp, seen)
        dj = JaxDriver(ped, dtype=np.float64, mesh=jax_mesh(2))
        for k, v in attrs.items():
            setattr(dj, k, v)
        dj.preprocess()
        infos = [dj.iterate(early=(i == 0)) for i in range(iters)]
    inds = ped.inds[1:]
    got = case_arrays(results(groups, 2), case)
    for k in ("hitnnn", "inverted"):
        np.testing.assert_array_equal(got[k], [i[k] for i in infos],
                                      err_msg=k)
    np.testing.assert_array_equal(
        got["markerdata"], np.stack([i.markerdata for i in inds]))
    ref = dict(scalefactor=np.array([i["scalefactor"] for i in infos]),
               haploweight=np.stack([i.haploweight for i in inds]),
               markersure=np.stack([i.markersure for i in inds]),
               pair=np.stack([dj.pair_tables[n] for n in ped.dous]))
    if inds[0].relhaplo is not None:
        ref["relhaplo"] = np.stack([i.relhaplo for i in inds])
    if case == "remap":
        assert ped.actrec is not None
        ref["actrec"] = np.array(ped.actrec)
    assert set(ref) <= set(got)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case}: {k}")
