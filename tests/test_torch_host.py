"""The port's own copies of the JAX package's host modules against the
originals: ``config`` (every ModelConfig field and derived size, for each
model family), ``utils.simulate`` (the same cohort arrays for the same
seed), ``pedigree`` (``from_host`` carries a JAX-package pedigree over,
copying every array) and ``native`` (the port's flip solver gives the
JAX package's answer).
"""
import dataclasses

import numpy as np
import pytest

import cnf2freq_tpu.config as jcfg
from cnf2freq_tpu.utils.simulate import simulate_f2 as jax_simulate_f2
from cnf2freq_tpu_torch import config as pcfg
from cnf2freq_tpu_torch.pedigree import Pedigree, from_host
from cnf2freq_tpu_torch.utils.simulate import simulate_f2

FAMILIES = [dict(), dict(numgen=2, haplotyping=False, relskews=False,
                         do_infprobs=False), dict(numgen=2),
            dict(selfing=True), dict(relskewstates=True)]
DERIVED = ("typebits", "numtypes", "numpaths", "numshifts", "numturns",
           "numslots", "numstates", "evengen", "turn_state_mask",
           "slot_parent_index", "deep_walk", "state_branch_bits")


@pytest.mark.parametrize("kw", FAMILIES,
                         ids=["f2", "f2_nohaplo", "ng2", "selfing",
                              "relskewstates"])
def test_config_copy_matches(kw):
    a, b = jcfg.ModelConfig(**kw), pcfg.ModelConfig(**kw)
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for name in DERIVED:
        assert getattr(a, name) == getattr(b, name), name
    assert [a.turn_shift_flip(t) for t in range(a.numturns)] == \
        [b.turn_shift_flip(t) for t in range(b.numturns)]
    for name in ("UNKNOWN", "SEXMARKER", "MINFACTOR", "ZP_NONE",
                 "ZP_PROPAGATE", "ZP_NO_EQUIVALENCE"):
        assert getattr(jcfg, name) == getattr(pcfg, name), name
    assert dataclasses.asdict(jcfg.RuntimeParams()) == \
        dataclasses.asdict(pcfg.RuntimeParams())


def _arrays(ped):
    inds = ped.inds[1:]
    out = {f: np.stack([getattr(i, f) for i in inds])
           for f in ("markerdata", "markersure", "haploweight", "relhaplo")}
    out["pars"] = np.array([i.pars for i in inds])
    out["dous"] = np.array(ped.dous)
    out["markerposes"] = ped.markerposes
    out["chromstarts"] = np.array(ped.chromstarts)
    out["truths"] = np.stack([ped.truths[i.n] for i in inds])
    return out


@pytest.mark.parametrize("kw", [dict(n_f2=7, n_markers=9, seed=3),
                                dict(n_f2=4, n_markers=5, seed=0,
                                     n_founder_pairs=2, n_chromosomes=2,
                                     missing_rate=0.0)],
                         ids=["one_chromosome", "two_chromosomes"])
def test_simulate_copy_matches(kw):
    a, b = _arrays(jax_simulate_f2(**kw)), _arrays(simulate_f2(**kw))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_from_host_copies_a_jax_pedigree():
    src = jax_simulate_f2(n_f2=3, n_markers=4, seed=1)
    src.inds[2].relhaplo[:] = 0.3
    ped = from_host(src)
    assert isinstance(ped, Pedigree)
    assert isinstance(ped.config, pcfg.ModelConfig)
    assert dataclasses.asdict(ped.config) == dataclasses.asdict(src.config)
    a, b = _arrays(src), _arrays(ped)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ped.getind("F2_1", create=False).n == \
        src.getind("F2_1", create=False).n
    # independent arrays
    ped.inds[1].haploweight[:] = 0.25
    assert (src.inds[1].haploweight != 0.25).all()
    assert ped.family_slots(ped.dous[0]) == src.family_slots(src.dous[0])


def test_native_flip_solver_matches():
    from cnf2freq_tpu.native import load_flipsolve as jax_load
    from cnf2freq_tpu_torch.native import load_flipsolve
    from cnf2freq_tpu_torch.updates.phaseflip import solve_component
    rng = np.random.default_rng(4)
    fams = [(np.array([0, 1, 2]), rng.normal(size=8)),
            (np.array([2, 3]), rng.normal(size=4)),
            (np.array([3, 4, 0]), rng.normal(size=8))]
    got = solve_component(fams, 5, lib=load_flipsolve())
    ref = solve_component(fams, 5, lib=jax_load())
    np.testing.assert_array_equal(got, ref)
