"""The coherence-carrying scan of the port against the JAX package.

On one simulate_f2 cohort (5 units x 11 markers, float64, randomised
haploweights and error rates; it aligns with no batch tile) the port's
``turn_weights_fast``, ``phase_coherence`` (every slot, through
``phase_coherence_slot``), ``posterior_weight``, ``scatter_coherence`` and
``engine.chromosome_scan(with_coherence=True)`` are held against the JAX
functions at rtol 1e-10.  The port's sweeps clip at 1e-30 as the TPU
kernel does, the JAX package's CPU scan at 1e-300; the probabilities get
atol 1e-14 for that.  Turn weights are compared where finite (impossible
turns carry MINFACTOR on both sides).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_util import cohort, jax_batch, t, torch_batch

from cnf2freq_tpu.engine import chromosome_scan as jax_chromosome_scan
from cnf2freq_tpu.hmm import probes as jax_probes
from cnf2freq_tpu.hmm.emission import build_blocks as jax_build_blocks
from cnf2freq_tpu.hmm.forward_backward import FBResult as JaxFBResult
from cnf2freq_tpu.hmm.transition import (interval_recomb as jax_recomb,
                                         transition_eigenvalues as jax_eig)
from cnf2freq_tpu.updates.scatter import (scatter_coherence as
                                          jax_scatter_coherence)
from cnf2freq_tpu_torch.engine import chromosome_scan
from cnf2freq_tpu_torch.hmm import probes
from cnf2freq_tpu_torch.hmm.emission import build_blocks
from cnf2freq_tpu_torch.updates.scatter import scatter_coherence

RTOL = 1e-10
PROB = dict(rtol=RTOL, atol=1e-14)
CASE = dict(B=5, M=11, seed=11)


@functools.lru_cache(maxsize=None)
def _case():
    """(numpy cohort, JAX scan with coherence, JAX turn weights and
    coherence from the scan's sweeps), each JAX program compiled once."""
    ped, fb, dists, cfg, params = cohort(**CASE)
    fbj = jax_batch(fb)
    dj = jnp.asarray(dists)
    res = jax.jit(lambda f, d: jax_chromosome_scan(
        f, d, cfg, params, with_coherence=True, use_scan_v2=False))(fbj, dj)

    @jax.jit
    def probes_of(f, d, fw_pre, fw_post, bw, fw_pre_f, fw_post_f, bw_f):
        fbres = JaxFBResult(fw_pre, fw_post, bw, fw_pre_f, fw_post_f, bw_f)
        blocks = jax_build_blocks(f, cfg, dtype=jnp.float64)
        lam = jax_eig(cfg, jax_recomb(cfg, params, d))
        return (jax_probes.turn_weights_fast(fbres, f, cfg),
                jax_probes.phase_coherence(fbres, blocks, f, cfg, lam), lam)

    sweeps = _sweeps(fb, dists, cfg, params)
    return (ped, fb, dists, cfg, params), res, sweeps, \
        probes_of(fbj, dj, *(jnp.asarray(x.numpy()) for x in sweeps))


def _sweeps(fb, dists, cfg, params):
    """The port's classic sweeps of the cohort (torch, float64)."""
    from cnf2freq_tpu_torch.hmm.emission import assemble_e_all
    from cnf2freq_tpu_torch.hmm.forward_backward import forward_backward
    fbt = torch_batch(fb)
    e = assemble_e_all(build_blocks(fbt, cfg), cfg)
    return forward_backward(e, t(dists), cfg, params)


def test_turn_weights_fast_matches():
    (_, fb, _, cfg, _), _, sweeps, (ref, _, _) = _case()
    got = probes.turn_weights_fast(sweeps, torch_batch(fb), cfg).numpy()
    ref = np.asarray(ref)
    finite = ref > -1e14
    np.testing.assert_array_equal(finite, got > -1e14)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=RTOL,
                               atol=1e-12)


def test_posterior_weight_matches():
    (_, fb, _, _, _), res, sweeps, _ = _case()
    total = t(np.asarray(res.total))
    got = probes.posterior_weight(sweeps, total, t(fb.shiftignore))
    ref = jax_probes.posterior_weight(
        JaxFBResult(*(jnp.asarray(x.numpy()) for x in sweeps)),
        jnp.asarray(res.total), jnp.asarray(fb.shiftignore))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_phase_coherence_matches():
    (_, fb, _, cfg, _), _, sweeps, (_, ref, lam) = _case()
    fbt = torch_batch(fb)
    blocks = build_blocks(fbt, cfg)
    got = probes.phase_coherence(sweeps, blocks, fbt, cfg, t(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    # coherence is a probability, measured away from the padding column
    assert ((got >= 0) & (got <= 1)).all()
    assert (got[:, :-1] != 0.5).any()
    # one slot on its own (its own pair total) equals its column
    one = probes.phase_coherence_slot(sweeps, blocks, fbt, cfg, t(lam), 4)
    np.testing.assert_allclose(one.numpy(), got[..., 4].numpy(), rtol=1e-13)


def test_scatter_coherence_matches():
    (ped, fb, _, _, _), res, _, _ = _case()
    coh = np.array(res.coherence)
    ids = [ind.n for ind in ped.inds[1:]]
    ind_index = {n: i for i, n in enumerate(ids)}
    NI, M = len(ids), ped.num_markers + 3
    lo = 2
    ref_num, ref_den = np.zeros((NI, M)), np.zeros((NI, M))
    jax_scatter_coherence(fb.slot_ind, fb.descendants, lo, coh, ref_num,
                          ref_den, ind_index)
    lut = np.full(max(ids) + 1, NI, dtype=np.int64)
    for n, i in ind_index.items():
        lut[n] = i
    num = torch.zeros((NI, M), dtype=torch.float64)
    den = torch.zeros((NI, M), dtype=torch.float64)
    scatter_coherence(t(fb.slot_ind), t(fb.descendants), lo, t(coh), num, den,
                      t(lut))
    np.testing.assert_allclose(num.numpy(), ref_num, rtol=RTOL)
    np.testing.assert_array_equal(den.numpy(), ref_den)
    assert ref_den[:, lo:lo + ped.num_markers].any()


def test_chromosome_scan_with_coherence_matches():
    (_, fb, dists, cfg, params), ref, _, _ = _case()
    got = chromosome_scan(torch_batch(fb), t(dists), cfg, params,
                          with_coherence=True)
    for name in ("total", "haplo_b12", "inf_accum", "pair", "fw_pre_f",
                 "bw_f", "coherence"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=1e-15, err_msg=name)
    for name in ("fw_pre", "bw"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **PROB)
    np.testing.assert_array_equal(got.haplo_mask.numpy(),
                                  np.asarray(ref.haplo_mask))
    tw, rtw = got.turn_weight.numpy(), np.asarray(ref.turn_weight)
    finite = rtw > -1e14
    np.testing.assert_array_equal(finite, tw > -1e14)
    np.testing.assert_allclose(tw[finite], rtw[finite], rtol=RTOL,
                               atol=1e-12)
    # without coherence the v2 pipeline runs, leaves coherence neutral and
    # gives the classic pipeline's statistics
    v2 = chromosome_scan(torch_batch(fb), t(dists), cfg, params)
    assert (v2.coherence == 0.5).all()
    for name in ("total", "haplo_b12", "inf_accum", "pair"):
        np.testing.assert_allclose(getattr(v2, name).numpy(),
                                   getattr(got, name).numpy(), rtol=RTOL,
                                   atol=1e-15, err_msg=name)
    tw2 = v2.turn_weight.numpy()
    np.testing.assert_array_equal(finite, tw2 > -1e14)
    np.testing.assert_allclose(tw2[finite], tw[finite], rtol=RTOL,
                               atol=1e-12)
