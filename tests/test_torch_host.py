"""The port's own copies of the JAX package's host modules against the
originals: ``config`` (every ModelConfig field and derived size, for each
model family), ``utils.simulate`` (the same cohort arrays for the same
seed), ``pedigree`` (``from_host`` carries a JAX-package pedigree over,
copying every array), ``native`` (the port's flip solver gives the
JAX package's answer) and ``updates.refflips`` (parity mode's
reference-exact flip stage: the WCNF solver on seeded clause sets and
the whole stage on a seeded cohort give the original's answers).
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


def _clause_sets(seed, nvar=12, ncl=40):
    """Seeded weighted clause sets over at most ``nvar`` variables, with
    repeated and opposite literals (dedup and tautologies) and ties."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ncl):
        k = int(rng.integers(1, 5))
        lits = [int(v) * (1 if rng.random() < 0.5 else -1)
                for v in rng.integers(1, nvar + 1, k)]
        out.append((int(rng.integers(0, 6)) * 1000, lits))
    return out


@pytest.mark.parametrize("seed,maxexact", [(0, None), (1, None), (2, None),
                                           (3, 4)],
                         ids=["s0", "s1", "s2", "s3_icm"])
def test_refflips_solver_matches(seed, maxexact, monkeypatch):
    """``_solve_wcnf`` of the copy against the original: exact enumeration
    (ties to the lowest assignment bits) and, with MAXEXACT lowered on
    both, iterated conditional modes."""
    import cnf2freq_tpu.updates.refflips as jref
    import cnf2freq_tpu_torch.updates.refflips as pref
    if maxexact is not None:
        monkeypatch.setattr(jref, "MAXEXACT", maxexact)
        monkeypatch.setattr(pref, "MAXEXACT", maxexact)
    clauses = _clause_sets(seed)
    got = pref._solve_wcnf(clauses, nbvar=12)
    assert got == jref._solve_wcnf(clauses, nbvar=12)
    assert any(got)


def test_reference_flips_matches():
    """The whole reference flip stage on a seeded 10-unit cohort with
    synthetic turn weights: the same winner and score.  The F1 parents are
    marked typed: an empty parent's turn bit is pinned, appears only as a
    positive literal, and the solver satisfies every clause of its
    families by setting it, so no flip would win."""
    import cnf2freq_tpu.updates.refflips as jref
    import cnf2freq_tpu_torch.updates.refflips as pref
    base = jax_simulate_f2(n_f2=10, n_markers=24, seed=3)
    for ind in base.inds[1:]:
        ind.empty = False
        base.fixtrees(ind.n)
    base.count_descendants()
    rng = np.random.default_rng(10)
    dous = list(base.dous)
    ids = [ind.n for ind in base.inds[1:]]
    ind_index = {n: i for i, n in enumerate(ids)}
    M, T = base.num_markers, base.config.numturns
    for ind in base.inds[1:]:
        ind.haploweight[:] = rng.uniform(0.05, 0.95, M)
    W = rng.normal(-1.0, 2.0, (len(dous), M, T))
    # the no-flip turn and its copies over the absent slots (4, 5)
    W[:, :, [0, 16, 32, 48]] = 0.0
    W[0, 3, 5] = -np.inf
    hc = rng.integers(0, 3, (len(ids), M)).astype(float)
    hb = hc * rng.uniform(0, 1, (len(ids), M))
    ref = jref.reference_flips(base, base.config, dous, 0, M, W, hb, hc,
                               ind_index)
    port = from_host(base)
    got = pref.reference_flips(port, port.config, dous, 0, M, W, hb, hc,
                               ind_index)
    assert ref is not None and got is not None
    assert got.flips == ref.flips and got.cover == ref.cover
    assert got.score == ref.score
