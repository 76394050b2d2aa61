"""The port's HMM building blocks (cnf2freq_tpu_torch/hmm) against the JAX
package, float64 on the CPU: the transition model at 1e-12 and the
emission blocks (ci / zp / side / inval options, vacant slots) at 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import cohort, jax_batch, t, torch_batch

from cnf2freq_tpu.config import (ZP_NO_EQUIVALENCE, ZP_NONE, ZP_PROPAGATE,
                                 ModelConfig, RuntimeParams)
from cnf2freq_tpu.hmm import emission as je
from cnf2freq_tpu.hmm import probes as jp
from cnf2freq_tpu.hmm import transition as jt
from cnf2freq_tpu_torch.hmm import emission as pe
from cnf2freq_tpu_torch.hmm import probes as pp
from cnf2freq_tpu_torch.hmm import transition as pt

CFG, PARAMS = ModelConfig(), RuntimeParams()
TOL = dict(rtol=1e-12, atol=1e-14)


def _dists(M=9, seed=0):
    return np.random.default_rng(seed).uniform(0.1, 5.0, M - 1)


def test_hadamard_and_fwht():
    for nbits in (3, 6):
        np.testing.assert_array_equal(pt.hadamard(nbits).numpy(),
                                      jt.hadamard(nbits))
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 64, 5)))
    np.testing.assert_allclose(pt.fwht(x, 1).numpy(),
                               np.einsum("gh,ahb->agb", jt.hadamard(6),
                                         x.numpy()), **TOL)


@pytest.mark.parametrize("with_ratemat", [False, True])
def test_recomb_and_eigenvalues(with_ratemat):
    d = _dists()
    rm = pt.rate_matrix(CFG, PARAMS, len(d)) if with_ratemat else None
    r_ref = jt.interval_recomb(CFG, PARAMS, jnp.asarray(d),
                               ratemat=None if rm is None
                               else jnp.asarray(rm))
    r = pt.interval_recomb(CFG, PARAMS, t(d),
                           ratemat=None if rm is None else t(rm))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), **TOL)
    np.testing.assert_allclose(pt.transition_eigenvalues(CFG, r).numpy(),
                               np.asarray(jt.transition_eigenvalues(
                                   CFG, r_ref)), **TOL)
    actrec = np.random.default_rng(2).uniform(-0.05, -0.01, (2, 9))
    np.testing.assert_array_equal(
        pt.rate_matrix(CFG, PARAMS, 8, actrec, 0),
        jt.rate_matrix(CFG, PARAMS, 8, actrec, 0))


def test_hadamard_transition_equals_dense():
    """H diag(lam) H / S == the dense xor-kernel matrix, on both
    packages, for every interval of a simulate_f2 map."""
    d = _dists()
    r = pt.interval_recomb(CFG, PARAMS, t(d))
    lam = pt.transition_eigenvalues(CFG, r)
    p = torch.as_tensor(np.random.default_rng(3).dirichlet(
        np.ones(64), size=(len(d), 8)))
    fast = pt.apply_transition(p, lam[:, None, :])
    for i in range(len(d)):
        dense = pt.transition_matrix(CFG, r[i])
        ref = jt.transition_matrix(CFG, jnp.asarray(r[i].numpy()))
        np.testing.assert_allclose(dense.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(fast[i].numpy(), (p[i] @ dense).numpy(),
                                   **TOL)
    ref_fast = jt.apply_transition(jnp.asarray(p.numpy()),
                                   jnp.asarray(lam.numpy())[:, None, :])
    np.testing.assert_allclose(fast.numpy(), np.asarray(ref_fast), **TOL)


_BLOCK_CASES = [
    dict(ci=False, zp=ZP_NONE, side=0, inval=None),
    dict(ci=True, zp=ZP_NONE, side=0, inval=None),
    dict(ci=True, zp=ZP_NO_EQUIVALENCE, side=1, inval=0),
    dict(ci=True, zp=ZP_NO_EQUIVALENCE, side=0, inval=1),
    dict(ci=False, zp=ZP_PROPAGATE, side=1, inval=None),
]


@pytest.mark.parametrize("case", _BLOCK_CASES,
                         ids=lambda c: "-".join(f"{k}{v}"
                                                for k, v in c.items()))
def test_build_blocks_matches(case):
    _, fb, _, cfg, _ = cohort(with_vacant=True)
    fbj, fbt = jax_batch(fb), torch_batch(fb)
    kw = dict(ci=case["ci"], zp=case["zp"], side=case["side"])
    a = case["inval"]
    jkw, tkw = dict(kw), dict(kw)
    if a is not None:
        jkw.update(inval=fbj.md[:, 0, :, a], insv=fbj.ms[:, 0, :, a])
        tkw.update(inval=fbt.md[:, 0, :, a], insv=fbt.ms[:, 0, :, a])
    ref = je.build_blocks(fbj, cfg, dtype=jnp.float64, **jkw)
    got = pe.build_blocks(fbt, cfg, dtype=torch.float64, **tkw)
    np.testing.assert_allclose(got.froot.numpy(), np.asarray(ref.froot),
                               **TOL)
    np.testing.assert_allclose(got.top.numpy(), np.asarray(ref.top), **TOL)
    for k in range(2):
        np.testing.assert_allclose(got.pb[k].numpy(), np.asarray(ref.pb[k]),
                                   **TOL)
    np.testing.assert_allclose(pe.assemble_e_all(got, cfg).numpy(),
                               np.asarray(je.assemble_e_all(ref, cfg)),
                               **TOL)


def test_emission_all_and_update_mask():
    _, fb, _, cfg, _ = cohort(with_vacant=True)
    fbj, fbt = jax_batch(fb), torch_batch(fb)
    np.testing.assert_allclose(
        pe.emission_all(fbt, cfg, ci=True).numpy(),
        np.asarray(je.emission_all(fbj, cfg, ci=True)), **TOL)
    for ci in (False, True):
        np.testing.assert_array_equal(
            pp.haplo_update_mask(fbt, cfg, ci=ci).numpy(),
            np.asarray(jp.haplo_update_mask(fbj, cfg, ci=ci)))
