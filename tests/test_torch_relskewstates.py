"""The RELSKEWSTATES extended state space of the port against the JAX
package.

Float64 on the CPU, one torch thread.  The module tests run on
simulate_f2(n_f2=8, n_markers=16, n_founder_pairs=2, seed=3) under
ModelConfig(relskewstates=True), with each individual's relhaplo drawn
from U(0.2, 0.9) (so that the coherence coupling is not flat) and
haploweights and error rates randomised, gathered with the Driver's
probe-dedup variants:

* the family batch (relh), build_blocks with the no-root-collapse
  default in the standard and GENOS update modes, with and without ci,
  probe_rule_factors under each tied_rule;
* ext_blocks, the sweeps (the plain twin of csrc/fb_ext.cu at V = 2),
  totals, posterior and turn weights, ext_statistics (rule 3 exempting
  the focal, the dead side-1 probes dropped), relskew_coherence_ext, the
  recombination expectations, the models module (relstate_emission,
  relstate_eigenvalues, relstate_scan: the flattened 128-state layout)
  and chromosome_scan_ext whole, at rtol 1e-9 / atol 1e-12;
* the Driver: three iterations against the JAX Driver on both iteration
  branches (the resident one gathers relh from the cohort's relhaplo
  column) at rtol 1e-8 / atol 1e-12, and the CLI with ``--model
  relskewstates`` against the JAX CLI within 2e-5, on one
  simulate_plantimpute_files(n_f2=12, n_markers=16, seed=11) file set;
* refusals: parity mode and probe rules raise before any work; a
  marker-blocked chromosome runs, on the Driver and through the CLI's
  --markerblock (tests/test_torch_blocked_families.py holds it to the
  whole Driver and the JAX package).
"""
import numpy as np
import pytest
import torch
import torch_ext_util as U

from cnf2freq_tpu_torch import Driver
from cnf2freq_tpu_torch.config import GENOS
from cnf2freq_tpu_torch.cli import main as port_main
from cnf2freq_tpu_torch.engine import chromosome_scan
from cnf2freq_tpu_torch.models import relskew_states as PM
from cnf2freq_tpu_torch.pedigree import from_host
from cnf2freq_tpu_torch.utils.simulate import simulate_plantimpute_files

MODEL = "relskewstates"


@pytest.fixture(scope="module")
def x():
    return U.ext_inputs(MODEL)


@pytest.fixture(scope="module")
def ref(x):
    return U.jax_reference(x)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return simulate_plantimpute_files(
        str(tmp_path_factory.mktemp("f2")), n_f2=12, n_markers=16,
        seed=11)[:3]


def test_family_batch(x):
    assert x["fb_np"].relh is not None and \
        (np.abs(x["fb_np"].relh - 0.5) > 1e-3).any()
    U.check_family(x)


@pytest.mark.parametrize("ci", [False, True], ids=["noci", "ci"])
@pytest.mark.parametrize("update", [0, GENOS], ids=["plain", "genos"])
def test_build_blocks_options(x, update, ci):
    U.check_blocks_options(x, update, ci)


@pytest.mark.parametrize("tied_rule", [True, False, "nonfocal"],
                         ids=str)
def test_probe_rule_factors(x, tied_rule):
    U.check_probe_rule_factors(x, tied_rule)


def test_ext_blocks(x, ref):
    U.check_ext_blocks(x, ref)


def test_sweeps(x, ref):
    U.check_sweeps(x, ref)


def test_ext_statistics(x, ref):
    U.check_statistics(x, ref)


def test_relskew_coherence_ext(x, ref):
    U.check_coherence(x, ref)


def test_recombination_expectations_ext(x, ref):
    U.check_recombination(x, ref)


def test_relskew_states_module(x, ref):
    """The models module's pieces and its own scan (relstate_scan: the
    flattened [2S, NS] layout, sweeps through fb_ext)."""
    import jax.numpy as jnp

    from cnf2freq_tpu.models import relskew_states as JM
    fbj, fbt = x["fbj"], x["fbt"]
    d = x["dists"]
    U.close(PM.relstate_emission(fbt, x["pcfg"]),
            JM.relstate_emission(fbj, x["jcfg"]))
    U.close(PM.relstate_eigenvalues(x["pcfg"], torch.as_tensor(d),
                                    fbt.relh[:, :-1], x["pparams"]),
            JM.relstate_eigenvalues(x["jcfg"], jnp.asarray(d),
                                    fbj.relh[:, :-1], x["jparams"]))
    got = PM.relstate_scan(fbt, torch.as_tensor(d), fbt.relh[:, :-1],
                           x["pcfg"], x["pparams"])
    for g, r in zip(got, ref["model_scan"]):
        U.close(g, r)
    U.close(got[0], ref["total"])


@pytest.mark.parametrize("with_coherence", [False, True])
def test_chromosome_scan_ext(x, ref, with_coherence):
    U.check_chromosome_scan(x, ref, with_coherence)


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "host_gathered"])
def test_driver_matches_jax(files, resident, record_property):
    U.check_driver(U.files_pedigree(files, MODEL), resident,
                   record_property)


def test_cli_matches_jax(files, tmp_path):
    U.check_cli(files, MODEL, tmp_path)


def test_refusals(x, files, tmp_path):
    """Parity mode and probe rules are standard-space only; a chromosome
    longer than marker_block runs marker-blocked (blocked_families.py), on
    the Driver and through the CLI, which writes its table; a
    marker_block that no chromosome exceeds runs."""
    ped = from_host(x["ped"])
    with pytest.raises(NotImplementedError, match="parity"):
        Driver(ped, device="cpu", parity=True)
    with pytest.raises(NotImplementedError, match="standard-space"):
        chromosome_scan(x["fbt"], torch.as_tensor(x["dists"]), x["pcfg"],
                        x["pparams"], probe_rules=True, n_variants=x["nv"])
    d = Driver(ped, device="cpu")
    d.marker_block = 8
    d.preprocess()
    assert np.isfinite(d.iterate(early=True)["loglik"])
    assert d.state.iter == 1
    d.marker_block = ped.num_markers
    d.iterate(early=True)
    out = tmp_path / "blocked.out"
    mapfile, pedfile, genfile = files
    assert port_main(["--mapfile", mapfile, "--pedfile", pedfile,
                      "--genfile", genfile, "--model", MODEL, "--markerblock",
                      "4", "--count", "1", "--device", "cpu", "--output",
                      str(out)]) == 0
    assert out.exists() and out.stat().st_size > 0


def test_driver_remap_distances(files):
    """Map re-estimation on an extended space: the Driver accumulates the
    extended recombination expectations (recomb_expectations_ext, held
    to the JAX function above) and updates ped.actrec once per chromosome
    and iteration; the next scan reads the new rates."""
    ped = from_host(U.files_pedigree(files, MODEL))
    d = Driver(ped, device="cpu")
    d.remap_distances = True
    d.preprocess()
    d.iterate(early=True)
    first = ped.actrec.copy()
    assert np.isfinite(first).all()
    assert (first[:, 1:] != d.params.baserec).any()
    d.iterate()
    assert not np.array_equal(first, ped.actrec)
