"""The port's device-resident iteration (``cnf2freq_tpu_torch/resident.py``)
against its host-gathered iteration, on the CPU in float64.  No JAX: the
port's form of tests/test_resident.py, without its selfing case (the port
carries the F2 model only).

* ``Driver.resident=True`` and ``False`` give equal ``iterate`` results
  (hitnnn, inverted, scalefactor, log-likelihood) and equal state to
  1e-13: on simulate_f2(n_f2=24, n_markers=24, n_founder_pairs=2,
  seed=3) with adaptive relhaplo on and off (its iterations 2 and 3
  apply phase flips, so the flip mirrors are exercised), on two
  chromosomes, with the units scanned in chunks of 8, after a mutation of
  the Pedigree between iterations, and with the negshift flip mode (with
  and without parent-pair swaps) forced onto the resident iteration;
* the mirrors are reused: on an unchanged Pedigree no iteration after
  the first uploads them, and a changed haploweight or markerdata is
  uploaded at the next iteration;
* pair tables stay on the device until they are read;
* ``resident`` defaults to auto: on for the native flip mode, off for
  negshift (the JAX package's rule).
"""
import numpy as np
import pytest
import torch

from cnf2freq_tpu_torch import Driver, copy_pedigree
from cnf2freq_tpu_torch.utils.simulate import simulate_f2

TOL = 1e-13
FIELDS = ("haploweight", "markerdata", "markersure", "relhaplo")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These cohorts are small: one intra-op thread runs them fastest,
    and does not contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f2_24():
    return simulate_f2(n_f2=24, n_markers=24, n_founder_pairs=2, seed=3)


def f2_two_chromosomes():
    return simulate_f2(n_f2=16, n_markers=12, n_founder_pairs=2, seed=11,
                       n_chromosomes=2)


def run(base, resident, iters=4, mutate=None, **attrs):
    """A fresh Driver on a copy of ``base`` with ``attrs`` set:
    preprocess and ``iters`` iterations; ``mutate(ped, i)`` runs before
    iteration i."""
    ped = copy_pedigree(base)
    drv = Driver(ped, dtype=torch.float64, device="cpu",
                 adaptive_relhaplo=attrs.pop("adaptive_relhaplo", True))
    drv.resident = resident
    for k, v in attrs.items():
        setattr(drv, k, v)
    uploads = []
    real = drv._upload_mirror

    def counted(x):
        uploads[-1] += 1
        return real(x)

    drv._upload_mirror = counted
    drv.preprocess()
    infos = []
    for i in range(iters):
        if mutate is not None:
            mutate(ped, i)
        uploads.append(0)
        infos.append(drv.iterate(early=(i == 0)))
    state = {f: np.stack([getattr(ind, f) for ind in ped.inds[1:]])
             for f in FIELDS}
    return dict(infos=infos, state=state, pairs=drv.pair_tables,
                uploads=uploads, drv=drv)


def assert_same(a, b):
    for x, y in zip(a["infos"], b["infos"]):
        # chunked scans sum the log-likelihood in another order
        assert x["loglik"] == pytest.approx(y["loglik"], rel=TOL)
        assert {**x, "loglik": 0} == {**y, "loglik": 0}
    assert len(a["infos"]) == len(b["infos"])
    for f in FIELDS:
        np.testing.assert_allclose(a["state"][f], b["state"][f], rtol=0,
                                   atol=TOL, err_msg=f)
    assert set(a["pairs"]) == set(b["pairs"])
    for n in a["pairs"]:
        np.testing.assert_allclose(a["pairs"][n], b["pairs"][n], rtol=0,
                                   atol=TOL)


@pytest.fixture(scope="module")
def base():
    return f2_24()


@pytest.fixture(scope="module")
def host_run(base):
    return run(base, resident=False)


@pytest.fixture(scope="module")
def resident_run(base):
    return run(base, resident=True)


def test_resident_matches_host(host_run, resident_run):
    assert_same(resident_run, host_run)
    # the fixture applies phase flips, so the flip mirrors ran
    assert any(i["inverted"] for i in resident_run["infos"])
    # adaptive relhaplo moved relhaplo
    assert (resident_run["state"]["relhaplo"] != 0.5).any()


def test_resident_matches_host_without_adaptive_relhaplo(base):
    a = run(base, resident=True, iters=3, adaptive_relhaplo=False)
    b = run(base, resident=False, iters=3, adaptive_relhaplo=False)
    assert_same(a, b)
    assert any(i["inverted"] for i in a["infos"])
    assert (a["state"]["relhaplo"] == 0.5).all()


def test_resident_matches_host_two_chromosomes():
    base = f2_two_chromosomes()
    assert base.num_chromosomes == 2
    a, b = run(base, resident=True, iters=3), run(base, resident=False,
                                                  iters=3)
    assert_same(a, b)


def test_chunked_resident_matches_whole(base, host_run):
    """Chunks of 8 units (three per chromosome) fold into the same
    accumulators; each chunk's skeleton is cached and reused."""
    a = run(base, resident=True, batch_size=8)
    assert_same(a, host_run)
    skel = [k for k in a["drv"]._cache if k[0] == "fb_light"]
    assert len(skel) == 3


def test_mirrors_are_reused(resident_run):
    """The first iteration uploads md, ms, hw and rh once each; later
    iterations on an unchanged Pedigree upload nothing."""
    assert resident_run["uploads"] == [4, 0, 0, 0]


def test_host_mutation_is_picked_up(base):
    """A haploweight and a markerdata changed between iterations reach the
    device: the next iteration uploads again and equals the host-gathered
    iteration given the same changes."""
    def mutate(ped, i):
        ind = ped.by_id(ped.dous[3])
        if i == 1:
            ind.haploweight[5:9] = 0.3
        if i == 2:
            ind.markerdata[2] = (2, 1)

    a = run(base, resident=True, iters=3, mutate=mutate)
    b = run(base, resident=False, iters=3, mutate=mutate)
    assert_same(a, b)
    assert a["uploads"] == [4, 2, 2]


def test_import_state_between_iterations(base):
    """The Driver's knobs restored by import_state (a resumed run) do not
    disturb the mirrors."""
    def resume(res):
        drv = res["drv"]
        drv.import_state(dict(scalefactor=0.02, oldhitnnn=5,
                              oldhitnnn2=3))
        return drv.iterate(), drv.export_state()

    a, b = run(base, resident=True, iters=1), run(base, resident=False,
                                                   iters=1)
    a["uploads"].append(0)
    assert resume(a) == resume(b)
    assert a["uploads"] == [4, 0]


def test_pair_tables_stay_on_the_device(base):
    ped = copy_pedigree(base)
    drv = Driver(ped, dtype=torch.float64, device="cpu")
    drv.preprocess()
    drv.iterate(early=True)
    assert drv._pair_pending and not drv._pair_tables
    tabs = drv.pair_tables
    assert not drv._pair_pending
    assert set(tabs) == set(ped.dous)
    for n in ped.dous:
        np.testing.assert_allclose(tabs[n].sum(axis=(1, 2)), 1.0,
                                   rtol=1e-12)


def test_resident_defaults_to_auto():
    ped = simulate_f2(n_f2=2, n_markers=3, seed=0)
    drv = Driver(ped, device="cpu")
    assert drv.resident is None and drv.flip_mode == "native"
    assert drv.parent_swap is False
    assert drv._use_resident()
    drv.flip_mode = "negshift"
    assert not drv._use_resident()
    drv.resident = True
    assert drv._use_resident()
    drv.flip_mode = "native"
    drv.resident = False
    assert not drv._use_resident()


def test_unknown_flip_mode_raises(base):
    drv = Driver(copy_pedigree(base), device="cpu")
    drv.flip_mode = "toulbar"
    with pytest.raises(ValueError, match="flip_mode"):
        drv.iterate()


@pytest.mark.parametrize("parent_swap", [False, True],
                         ids=["negshift", "negshift_parentswap"])
def test_negshift_on_the_resident_iteration(base, parent_swap):
    """Negshift forced onto the resident iteration (resident=True) equals
    negshift on its default, the host-gathered iteration."""
    a = run(base, resident=True, iters=3, flip_mode="negshift",
            parent_swap=parent_swap)
    b = run(base, resident=None, iters=3, flip_mode="negshift",
            parent_swap=parent_swap)
    assert not b["drv"]._use_resident()
    assert_same(a, b)
    assert any(i["inverted"] for i in a["infos"])
