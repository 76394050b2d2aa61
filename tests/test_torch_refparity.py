"""The port's copy of ``utils/refparity.py`` (the reference-parity
harness) against the JAX package's (numpy only, no JAX compile).

* The paths (``REPO``, ``REFBUILD``, ``REF_BINARY``, ``TOULBAR``, a
  variant's binary) and ``have_reference()`` are the JAX module's.
* ``parse_dump``: the dump text that the port's ``write_haplotype_dump``
  writes after each of two iterations of the port's Driver (CPU, float64,
  ``simulate_f2(n_f2=12, n_markers=16)``, whose units carry priors, so the
  prior columns are present; and a two-chromosome cohort) parses into the
  same ``IterState`` lists, field by field, in both packages.
  ``state_from_pedigree`` of both packages gives the same state of the
  port's pedigree after that run, and ``compare`` of the last parsed
  block against it finds no genotype mismatch and at most the dump's
  rounding in each column.
* ``genotype_match`` and ``compare`` give the same results in both
  packages on seeded random state pairs with swapped genotype rows
  (haploweight mirrored, markersure columns swapped), homozygous markers,
  names missing from ``got`` and real genotype mismatches.
* ``test_trajectory_parity`` mirrors ``tests/test_refparity.py``'s with
  the port's parity Driver; it needs the compiled reference binary and the
  PlantImpute demo, and skips where either is absent, as that file does.
"""
import dataclasses
import io
import os

import numpy as np
import pytest
import torch
from torch_port_util import DUMP_ATOL

from cnf2freq_tpu.utils import refparity as jrp
from cnf2freq_tpu_torch import Driver
from cnf2freq_tpu_torch.io.outputs import write_haplotype_dump
from cnf2freq_tpu_torch.utils import refparity as prp
from cnf2freq_tpu_torch.utils.simulate import simulate_f2

COHORTS = {"one_chromosome": dict(n_f2=12, n_markers=16),
           "two_chromosomes": dict(n_f2=12, n_markers=8, n_chromosomes=2)}


@pytest.fixture(scope="module", params=sorted(COHORTS))
def dumped(request):
    """(the port's pedigree after two iterations, the dump text written
    after each)."""
    ped = simulate_f2(**COHORTS[request.param])
    drv = Driver(ped, dtype=torch.float64, device="cpu")
    drv.preprocess()
    out = io.StringIO()
    for i in range(2):
        drv.iterate(early=(i == 0))
        write_haplotype_dump(ped, out, reset_negshift=False)
    return ped, out.getvalue()


def assert_same_states(a, b):
    """Two IterStates (either package's IndState) equal, field by
    field."""
    assert list(a) == list(b)
    for name in a:
        for f in dataclasses.fields(prp.IndState):
            x, y = getattr(a[name], f.name), getattr(b[name], f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


def test_paths_match_jax():
    for name in ("REPO", "REFBUILD", "REF_BINARY", "TOULBAR"):
        assert getattr(prp, name) == getattr(jrp, name), name
    assert prp.variant_binary("selfing") == jrp.variant_binary("selfing")
    assert prp.have_reference() == jrp.have_reference()
    assert prp.have_variant("selfing") == jrp.have_variant("selfing")


def test_parse_dump_matches_jax(dumped):
    ped, text = dumped
    # the units' prior columns are in the text
    assert any(len(ln.split()) == 11 for ln in text.splitlines())
    M = ped.num_markers
    got, ref = prp.parse_dump(text, M), jrp.parse_dump(text, M)
    assert len(got) == len(ref) == 2
    n_state = sum(i.haploweight is not None for i in ped.inds[1:])
    for a, b in zip(got, ref):
        assert len(a) == n_state
        assert_same_states(a, b)


def test_state_from_pedigree_matches_jax(dumped):
    ped, _ = dumped
    assert_same_states(prp.state_from_pedigree(ped),
                       jrp.state_from_pedigree(ped))


def test_dump_round_trip(dumped):
    ped, text = dumped
    last = prp.parse_dump(text, ped.num_markers)[-1]
    state = prp.state_from_pedigree(ped)
    dev = prp.compare(last, state)
    assert dev["genotype_mismatches"] == 0, dev
    for col in ("haploweight", "markersure", "relhaplo"):
        assert dev[col] <= DUMP_ATOL, dev
    assert dev == jrp.compare(last, state)


def random_pair(seed, n=6, M=20):
    """(ref, got, the name dropped from got, the genotype mismatches
    made): ``got`` holds ``ref``'s state with about half of each
    individual's genotype rows swapped (haploweight mirrored, and at
    heterozygous markers markersure columns swapped), noise of 1e-3, the
    last name dropped and some genotypes changed to another homozygous
    pair.  A mirrored haploweight at a homozygous marker departs by up to
    1: ``compare`` leaves those markers out."""
    rng = np.random.default_rng(seed)
    ref, got = {}, {}
    for k in range(n):
        name = f"I{k}"
        md = rng.integers(1, 3, (M, 2))
        md[rng.random(M) < 0.3] = (1, 1)         # homozygous markers
        hw = rng.uniform(0.0, 1.0, M)
        ms = rng.uniform(0.0, 0.5, (M, 2))
        rh = rng.uniform(0.0, 1.0, M)
        ref[name] = dict(ind_id=k + 1, name=name, haploweight=hw,
                         markerdata=md, negshift=np.zeros(M),
                         markersure=ms, relhaplo=rh)
        swap = rng.random(M) < 0.5
        gmd = np.where(swap[:, None], md[:, ::-1], md)
        bad = rng.random(M) < 0.15
        gmd[bad] = np.where((md[bad] == 2).all(axis=1)[:, None], 1, 2)
        ghw = np.where(swap, 1.0 - hw, hw) + rng.normal(0, 1e-3, M)
        het = md[:, 0] != md[:, 1]
        gms = np.where((swap & het)[:, None], ms[:, ::-1], ms) + \
            rng.normal(0, 1e-3, (M, 2))
        got[name] = dict(ind_id=k + 1, name=name, haploweight=ghw,
                         markerdata=gmd, negshift=np.zeros(M),
                         markersure=gms,
                         relhaplo=rh + rng.normal(0, 1e-3, M),
                         bad=int(bad.sum()))
    dropped = f"I{n - 1}"
    del got[dropped]
    mismatches = sum(g.pop("bad") for g in got.values())
    return ref, got, dropped, mismatches


def as_states(raw, cls):
    return {k: cls(**v) for k, v in raw.items()}


@pytest.mark.parametrize("seed", range(4))
def test_compare_and_genotype_match_match_jax(seed):
    ref, got, dropped, mismatches = random_pair(seed)
    states = {pkg: (as_states(ref, mod.IndState),
                    as_states(got, mod.IndState))
              for pkg, mod in (("port", prp), ("jax", jrp))}
    p_ref, p_got = states["port"]
    j_ref, j_got = states["jax"]
    for name in p_got:
        m = prp.genotype_match(p_ref[name], p_got[name])
        np.testing.assert_array_equal(
            m, jrp.genotype_match(j_ref[name], j_got[name]))
        assert m.dtype == bool
    out = prp.compare(p_ref, p_got)
    assert out == jrp.compare(j_ref, j_got)
    # what the pairs exercise: mismatches counted, swapped rows mirrored
    # and homozygous markers left out of the haploweight deviation (the
    # noise, not the mirror, is the deviation), the dropped name skipped
    assert out["genotype_mismatches"] == mismatches > 0
    assert out["haploweight"] < 0.01 and out["markersure"] < 0.01
    assert prp.compare({dropped: p_ref[dropped]}, p_got) == dict(
        haploweight=0.0, markersure=0.0, relhaplo=0.0,
        genotype_mismatches=0.0)


def test_trajectory_parity(tmp_path):
    """tests/test_refparity.py's trajectory check with the port's
    Driver(parity=True) on the CPU in float64."""
    from test_refparity import GEN, M, MAP, PED

    from cnf2freq_tpu_torch.io import load_plantimpute
    if not prp.have_reference() or not all(
            os.path.exists(p) for p in (MAP, PED, GEN)):
        pytest.skip("instrumented reference binary not built (.refbuild) "
                    "or the PlantImpute demo absent")
    count = 10
    ref_iters = prp.run_reference(MAP, PED, GEN, count, str(tmp_path), M)
    assert len(ref_iters) == count
    ped = load_plantimpute(MAP, PED, GEN)
    drv = Driver(ped, parity=True, dtype=torch.float64, device="cpu")
    drv.preprocess()
    dev = prp.compare(ref_iters[0], prp.state_from_pedigree(ped))
    assert dev["genotype_mismatches"] == 0
    assert dev["haploweight"] < 1e-12 and dev["markersure"] < 1e-12
    for t in range(1, count):
        drv.iterate(early=False)
        dev = prp.compare(ref_iters[t], prp.state_from_pedigree(ped))
        assert dev["genotype_mismatches"] == 0, (t, dev)
        assert dev["haploweight"] < 1e-9, (t, dev)
        assert dev["markersure"] < 1e-9, (t, dev)
        assert dev["relhaplo"] < 1e-9, (t, dev)
