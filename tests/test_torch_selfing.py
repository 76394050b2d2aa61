"""The SELFING extended state space of the port against the JAX package.

Float64 on the CPU, one torch thread.  The module tests run on
simulate_selfed(n_lines=6, n_markers=16, generations=4, seed=2) (the
cohort size of tests/test_engine_ext.py), gathered with the Driver's 16
probe-dedup variants (every selfed unit holds its parent in both parent
slots), haploweights and error rates randomised:

* the family batch (selfgen), build_blocks with the HBD root override in
  the standard and GENOS update modes, with and without ci,
  probe_rule_factors under each tied_rule;
* ext_blocks, the sweeps of extended_forward_backward (the plain twin of
  csrc/fb_ext.cu; the non-symmetric selfprec coupling shows the backward
  sweep's orientation), the totals, posterior and turn weights,
  ext_statistics, coherence_slot_ext on every slot, the recombination
  expectations (from the sweeps and from stored sweeps), the models
  module (collapse_focal, selfing_factors, selfprec_tensor,
  selfing_emission, selfing_scan) and chromosome_scan_ext whole, at
  rtol 1e-9 / atol 1e-12 (the Walsh-Hadamard products sum in another
  order: matrix products in JAX, butterflies here);
* the Driver: three iterations (the first early) against the JAX Driver
  on both iteration branches, the port's rules patched into the JAX side
  (``torch_port_util.run_pair``), state at rtol 1e-8 / atol 1e-12, as
  the other Driver parity tests; and the CLI with ``--model selfing``
  against the JAX CLI within 2e-5 (5-6 printed decimals), on one
  simulate_plantimpute_selfed_files(n_lines=6, n_markers=16,
  generations=4, seed=2) file set.
"""
import pytest
import torch
import torch_ext_util as U

from cnf2freq_tpu_torch.config import GENOS
from cnf2freq_tpu_torch.models import selfing as PM
from cnf2freq_tpu_torch.utils.simulate import \
    simulate_plantimpute_selfed_files

MODEL = "selfing"


@pytest.fixture(scope="module")
def x():
    return U.ext_inputs(MODEL)


@pytest.fixture(scope="module")
def ref(x):
    return U.jax_reference(x)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return simulate_plantimpute_selfed_files(
        str(tmp_path_factory.mktemp("selfed")), n_lines=6, n_markers=16,
        generations=4, seed=2)[:3]


def test_family_batch(x):
    assert x["nv"] == 16
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


def test_coherence_slot_ext(x, ref):
    U.check_coherence(x, ref)


def test_recombination_expectations_ext(x, ref):
    U.check_recombination(x, ref)


def test_selfing_module(x, ref):
    """The models module's pieces and its own scan (selfing_scan: the
    legacy [S, NS] layout, sweeps through fb_ext)."""
    import jax.numpy as jnp

    from cnf2freq_tpu.models import selfing as JM
    fbj, fbt = x["fbj"], x["fbt"]
    cj = JM.collapse_focal(fbj.md[:, 0], fbj.ms[:, 0])
    cp = PM.collapse_focal(fbt.md[:, 0], fbt.ms[:, 0])
    for a, b in zip(cp, cj):
        U.close(a, b)
    U.close(PM.selfing_factors(fbt.selfgen),
            JM.selfing_factors(fbj.selfgen))
    d = x["dists"]
    U.close(PM.selfprec_tensor(fbt.selfgen, torch.as_tensor(d), -0.02),
            JM.selfprec_tensor(fbj.selfgen, jnp.asarray(d), -0.02))
    U.close(PM.selfing_emission(fbt, x["pcfg"]),
            JM.selfing_emission(fbj, x["jcfg"]))
    got = PM.selfing_scan(fbt, torch.as_tensor(d), fbt.selfgen, x["pcfg"],
                          x["pparams"])
    for g, r in zip(got, ref["model_scan"]):
        U.close(g, r)
    # the two routes agree on the total log-likelihood
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
