"""The no-haplotyping deep-walk engine of the port (F2_NOHAPLO,
settings.h:60-73) against the JAX package's, and the ``--model`` runs of
both command lines.

* Engine functions (``engine_nohaplo``): the emission with and without
  ``ci`` and as the GENOSPROBE side chains, the feasibility, the pair
  table, the line origin and the whole scan against the JAX functions at
  rtol 1e-10, float64, on simulate_f2 cohorts with missing genotypes,
  errors and vacant parents (the F1 focals of the cohort).
* Driver: the port's Driver against the JAX Driver, 3 iterations (the
  first early), on the resident iteration and with resident=False: pair
  tables at rtol 1e-8, iteration records equal, no haploweight moved
  (the family runs no update), the same markerdata, and the line-origin
  tables of both Drivers at rtol 1e-8; a marker-blocked run is refused.
* CLI: ``--model nohaplo --lineorigin`` and ``--model ng2`` on a 12 x 16
  PlantImpute set, the port's CLI on the CPU against the JAX CLI: every
  number of the genotype table, the line-origin table and the dump
  within 2e-5.
"""
import os

import numpy as np
import pytest
import torch
from torch_port_util import assert_same_numbers, jax_batch, run_jax_cli, t

from cnf2freq_tpu_torch import Driver, copy_pedigree
from cnf2freq_tpu_torch import config as pconfig
from cnf2freq_tpu_torch import engine_nohaplo as P
from cnf2freq_tpu_torch.cli import main as port_main
from cnf2freq_tpu_torch.hmm.family import gather_family
from cnf2freq_tpu_torch.pedigree import from_host
from cnf2freq_tpu_torch.utils.simulate import simulate_plantimpute_files

RTOL, ATOL = 1e-10, 1e-13


def nohaplo_ped(seed=0, n_f2=10, n_markers=8, missing=0.3):
    """simulate_f2 under F2_NOHAPLO with founder flags cleared (the
    reference's no-haplotyping fixtrees sets none), as
    tests/test_nohaplo.py builds it."""
    from cnf2freq_tpu.config import F2_NOHAPLO
    from cnf2freq_tpu.utils.simulate import simulate_f2
    ped = simulate_f2(n_f2=n_f2, n_markers=n_markers, n_founder_pairs=2,
                      missing_rate=missing, error_rate=0.05, seed=seed)
    ped.config = F2_NOHAPLO
    for ind in ped.inds[1:]:
        ind.founder = False
    return ped


@pytest.fixture(scope="module")
def inputs():
    import jax.numpy as jnp

    from cnf2freq_tpu.config import F2_NOHAPLO
    ped = nohaplo_ped(seed=2)
    # the F2 units and two F1 units (vacant grandparents, founder parents)
    focals = list(ped.dous) + [i.n for i in ped.inds[1:]
                               if i.pars[0] and i.n not in ped.dous][:2]
    fb = gather_family(from_host(ped), focals, 0, ped.num_markers - 1)
    return dict(fb=fb, fbj=jax_batch(fb), fbt=fb.to("cpu", torch.float64),
                jcfg=F2_NOHAPLO, pcfg=from_host(ped).config,
                dists=np.diff(ped.markerposes), jnp=jnp)


def _close(got, ref, err_msg=""):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(ref, dtype=np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def test_emission_feasibility_pair(inputs):
    from cnf2freq_tpu import engine_nohaplo as J
    x = inputs
    assert x["fb"].md.shape[1] == 7
    for ci in (False, True):
        _close(P.nohaplo_emission(x["fbt"], x["pcfg"], ci=ci),
               J.nohaplo_emission(x["fbj"], x["jcfg"], ci=ci))
        for side in range(2):
            for mv in (1, 2):
                _close(P.nohaplo_emission(x["fbt"], x["pcfg"], ci=ci,
                                          inval=mv, side=side),
                       J.nohaplo_emission(x["fbj"], x["jcfg"], ci=ci,
                                          inval=mv, side=side))
    np.testing.assert_array_equal(
        P.nohaplo_feasibility(x["fbt"], x["pcfg"], ci=True).numpy(),
        np.asarray(J.nohaplo_feasibility(x["fbj"], x["jcfg"], ci=True)))
    B, _, M, _ = x["fb"].md.shape
    rng = np.random.default_rng(6)
    W = rng.uniform(0.0, 1.0, (B, M, 1, 4))
    _close(P.nohaplo_pair(x["fbt"], x["pcfg"], t(W), ci=True),
           J.nohaplo_pair(x["fbj"], x["jcfg"], x["jnp"].asarray(W), ci=True))
    _close(P.nohaplo_line_origin(x["fbt"], x["pcfg"], t(W[:, :, 0])),
           J.nohaplo_line_origin(x["fbj"], x["jcfg"],
                                 x["jnp"].asarray(W[:, :, 0])))


def test_chromosome_scan_nohaplo(inputs):
    from cnf2freq_tpu import engine_nohaplo as J
    from cnf2freq_tpu.config import RuntimeParams
    x = inputs
    d = x["dists"]
    rj = J.chromosome_scan_nohaplo(x["fbj"], x["jnp"].asarray(d), x["jcfg"],
                                   RuntimeParams())
    rp = P.chromosome_scan_nohaplo(x["fbt"], torch.as_tensor(d), x["pcfg"],
                                   pconfig.RuntimeParams())
    for f in rj._fields:
        if f == "haplo_mask":
            assert not rp.haplo_mask.any() and not np.asarray(
                rj.haplo_mask).any()
            continue
        _close(getattr(rp, f), getattr(rj, f), err_msg=f)


def _run(driver, iters=3):
    driver.preprocess()
    return [driver.iterate(early=(i == 0)) for i in range(iters)]


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "host_gathered"])
def test_driver_matches_jax(resident):
    """Both Drivers' pair tables, iteration records and line-origin tables
    after three iterations; nothing of the Pedigree's parameters moves."""
    from cnf2freq_tpu.driver import Driver as JaxDriver
    base = nohaplo_ped(seed=7, n_f2=12, n_markers=16)
    dj = JaxDriver(copy_pedigree(base), dtype=np.float64)
    dj.resident = resident
    dp = Driver(from_host(base), dtype=torch.float64, device="cpu")
    dp.resident = resident
    assert dp._use_resident() == resident
    hw0 = np.stack([i.haploweight for i in dp.ped.inds[1:]])
    ij, ip = _run(dj), _run(dp)
    for a, b in zip(ij, ip):
        assert (a["hitnnn"], a["inverted"]) == (b["hitnnn"], b["inverted"])
        assert b["scalefactor"] == pytest.approx(a["scalefactor"],
                                                 rel=1e-12)
    assert set(dp.pair_tables) == set(dj.pair_tables)
    for n, tab in dj.pair_tables.items():
        np.testing.assert_allclose(dp.pair_tables[n], tab, rtol=1e-8,
                                   atol=1e-12)
    np.testing.assert_array_equal(
        np.stack([i.haploweight for i in dp.ped.inds[1:]]), hw0)
    np.testing.assert_array_equal(
        np.stack([i.markerdata for i in dp.ped.inds[1:]]),
        np.stack([i.markerdata for i in dj.ped.inds[1:]]))
    lj, lp = dj.line_origin_tables(), dp.line_origin_tables()
    for n, tab in lj.items():
        np.testing.assert_allclose(lp[n], tab, rtol=1e-8, atol=1e-12)


def test_blocked_refused():
    d = Driver(from_host(nohaplo_ped()), device="cpu")
    d.marker_block = 64
    d.preprocess()
    with pytest.raises(NotImplementedError, match="whole-chromosome"):
        d.iterate(early=True)


# ---------------------------------------------------------------------------
# The command lines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 12 x 16 PlantImpute file set."""
    return simulate_plantimpute_files(str(tmp_path_factory.mktemp("files")),
                                      n_f2=12, n_markers=16, seed=11)[:3]


@pytest.mark.parametrize("model", ["nohaplo", "ng2"])
def test_cli_model(model, files, tmp_path):
    """--model nohaplo --lineorigin and --model ng2 (--count 2 --output
    --dump) on both CLIs: every printed number within 2e-5.  The JAX
    package has no line-origin reporter for ng2, so that run has none."""
    mapfile, pedfile, genfile = files
    outs = ("out", "dump") + (("lo",) if model == "nohaplo" else ())
    for tag, run, extra in (("jax", run_jax_cli, []),
                            ("port", port_main, ["--device", "cpu"])):
        args = ["--mapfile", mapfile, "--pedfile", pedfile, "--genfile",
                genfile, "--count", "2", "--model", model]
        for ext in outs:
            flag = {"out": "--output", "dump": "--dump",
                    "lo": "--lineorigin"}[ext]
            args += [flag, str(tmp_path / f"{tag}.{ext}")]
        assert run(args + extra) == 0
    for ext in outs:
        assert_same_numbers(str(tmp_path / f"port.{ext}"),
                            str(tmp_path / f"jax.{ext}"))
    with open(tmp_path / "port.out") as f:
        assert sum(line.startswith("F2_") for line in f) == 12
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{tag}.{ext}" for tag in ("jax", "port") for ext in outs)
