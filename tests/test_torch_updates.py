"""The port's merge, update and flip-scoring stages against the JAX package
(float64, CPU, random inputs from a numpy seed): segment-sum merges,
caplogitchange / cappedgd, the haploweight and infprob updates,
relskew_ratio / relskew_weight and the flip scorer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import t

from cnf2freq_tpu.config import RuntimeParams
from cnf2freq_tpu.parallel import collective as jc
from cnf2freq_tpu.updates import capped as jcap
from cnf2freq_tpu.updates import parameter_updates as jpu
from cnf2freq_tpu.updates import phaseflip as jpf
from cnf2freq_tpu.updates import relskew as jrs
from cnf2freq_tpu_torch.parallel import collective as pc
from cnf2freq_tpu_torch.updates import capped as pcap
from cnf2freq_tpu_torch.updates import parameter_updates as ppu
from cnf2freq_tpu_torch.updates import phaseflip as ppf
from cnf2freq_tpu_torch.updates import relskew as prs

TOL = dict(rtol=1e-10, atol=1e-13)
PARAMS = RuntimeParams()


def _slots(rng, B, NI):
    """slot_ind [B, 7] with vacant slots and duplicate members."""
    s = rng.integers(1, NI + 1, size=(B, 7)).astype(np.int32)
    s[rng.random((B, 7)) < 0.2] = 0
    s[:, 3] = np.where(rng.random(B) < 0.3, s[:, 2], s[:, 3])
    return s


def test_merges_match():
    rng = np.random.default_rng(0)
    B, M, NI = 9, 6, 12
    slot_ind = _slots(rng, B, NI)
    ids = np.arange(1, NI + 1)
    lut = np.full(NI + 1, NI, dtype=np.int32)
    lut[ids] = ids - 1
    b12 = rng.uniform(0, 1, (B, M, 7, 2))
    b12[rng.random((B, M, 7)) < 0.1] = 0.0
    mask = rng.random((B, M, 7)) < 0.8
    hw = rng.uniform(0, 1, (B, 7, M))
    hw[rng.random((B, 7, M)) < 0.1] = 1.0
    desc = rng.integers(1, 4, B).astype(np.int32)
    accum = rng.uniform(0, 1, (B, M, 7, 2, 2))
    emptyslot = rng.random((B, 7)) < 0.2

    hb, hc = pc.merge_haplos(t(b12), t(mask), t(hw), t(slot_ind), t(desc),
                             t(lut, torch.int64), NI)
    rhb, rhc = jc.merge_haplos(*(jnp.asarray(x) for x in
                                 (b12, mask, hw, slot_ind, desc, lut)), NI)
    np.testing.assert_allclose(hb.numpy(), np.asarray(rhb), **TOL)
    np.testing.assert_allclose(hc.numpy(), np.asarray(rhc), **TOL)
    for empty in (None, emptyslot):
        inf = pc.merge_infprobs(t(accum), t(slot_ind), t(desc),
                                t(lut, torch.int64), NI,
                                emptyslot=None if empty is None
                                else t(empty))
        rinf = jc.merge_infprobs(jnp.asarray(accum), jnp.asarray(slot_ind),
                                 jnp.asarray(desc), jnp.asarray(lut), NI,
                                 emptyslot=None if empty is None
                                 else jnp.asarray(empty))
        np.testing.assert_allclose(inf.numpy(), np.asarray(rinf), **TOL)
    np.testing.assert_allclose(
        pc.merge_slot_stats(t(b12), t(slot_ind), NI).numpy(),
        np.asarray(jc.merge_slot_stats(jnp.asarray(b12),
                                       jnp.asarray(slot_ind), NI)), **TOL)


def test_caplogitchange_and_cappedgd():
    rng = np.random.default_rng(1)
    N = 200
    orig = rng.uniform(0.01, 0.99, N)
    eps = rng.uniform(1e-6, 1e-4, N)
    intended = rng.uniform(-0.1, 1.1, N)
    brk = rng.random(N) < 0.5
    v, h = pcap.caplogitchange(t(intended), t(orig), t(eps), t(brk))
    rv, rh = jcap.caplogitchange(jnp.asarray(intended), jnp.asarray(orig),
                                 jnp.asarray(eps), jnp.asarray(brk))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), **TOL)
    np.testing.assert_array_equal(h.numpy(), np.asarray(rh))

    # a pull toward a per-lane target with an entropy term
    target = rng.uniform(0.05, 0.95, N)
    strength = rng.uniform(0.5, 20.0, N)

    def grad_t(x):
        return (t(target) - x) * t(strength) / (x - x * x) + \
            torch.log(1.0 / x - 1.0)

    def grad_j(x):
        return (jnp.asarray(target) - x) * jnp.asarray(strength) / \
            (x - x * x) + jnp.log(1.0 / x - 1.0)

    for sf in (0.013, 0.2, 0.0):
        v, h = pcap.cappedgd(grad_t, t(orig), t(eps), sf, breakathalf=t(brk))
        rv, rh = jcap.cappedgd(grad_j, jnp.asarray(orig), jnp.asarray(eps),
                               sf, breakathalf=jnp.asarray(brk))
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_array_equal(h.numpy(), np.asarray(rh))


def _update_inputs(rng, N=14, M=10):
    md = rng.integers(0, 3, (N, M, 2)).astype(np.int32)
    ms = np.where(md > 0, rng.uniform(0.0, 0.3, (N, M, 2)), 0.0)
    return md, ms


def test_update_haploweights_matches():
    rng = np.random.default_rng(2)
    N, M = 14, 10
    md, ms = _update_inputs(rng, N, M)
    hw = rng.uniform(0.02, 0.98, (N, M))
    hc = rng.integers(0, 4, (N, M)).astype(float)
    hb = hc * rng.uniform(0, 1, (N, M))
    rel = rng.uniform(0.1, 0.9, (N, M))
    desc = rng.integers(1, 5, N).astype(float)
    children = rng.integers(0, 4, N).astype(float)
    lastinv = rng.random((N, M)) < 0.3
    active = (rng.random((N, M)) < 0.9) & (hc > 0)
    for sf in (0.013, 0.0):
        args = (hw, hb, hc, md, ms, rel, desc, children, lastinv, active)
        got = ppu.update_haploweights(*(t(x) for x in args), PARAMS, sf)
        ref = jpu.update_haploweights(*(jnp.asarray(x) for x in args),
                                      PARAMS, sf)
        np.testing.assert_allclose(got.haploweight.numpy(),
                                   np.asarray(ref.haploweight), rtol=1e-9,
                                   atol=1e-12)
        assert int(got.hits) == int(ref.hits)


def test_update_infprobs_matches():
    rng = np.random.default_rng(3)
    N, M = 14, 10
    md, ms = _update_inputs(rng, N, M)
    prior, psure = _update_inputs(rng, N, M)
    accum = rng.uniform(0, 2, (N, M, 2, 2))
    accum[rng.random((N, M, 2, 2)) < 0.2] = 0.0
    has_prior = rng.random(N) < 0.8
    children = rng.integers(0, 4, N).astype(float)
    args = (accum, md, ms, prior, psure, has_prior, children)
    got = ppu.update_infprobs(*(t(x) for x in args), PARAMS, 0.013)
    ref = jpu.update_infprobs(*(jnp.asarray(x) for x in args), PARAMS,
                              0.013)
    np.testing.assert_allclose(got.newprob.numpy(), np.asarray(ref.newprob),
                               rtol=1e-9, atol=1e-12)
    assert int(got.hits) == int(ref.hits)
    x = rng.uniform(0.05, 0.95, 50)
    y, g, h = (rng.uniform(0.05, 2.0, 50) for _ in range(3))
    np.testing.assert_allclose(
        ppu.pseudo_likelihood_grad(t(y), t(g), t(h), t(x)).numpy(),
        np.asarray(jpu.pseudo_likelihood_grad(*(jnp.asarray(v)
                                                for v in (y, g, h, x)))),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("M", [1, 2, 11])
def test_relskew_matches(M):
    rng = np.random.default_rng(4)
    hw = rng.uniform(0.0, 1.0, (7, M))
    hw[:, 0] = np.where(rng.random(7) < 0.3, 0.0, hw[:, 0])
    rh = rng.uniform(1e-4, 1 - 1e-4, (7, M))
    np.testing.assert_allclose(
        prs.relskew_ratio(t(hw), t(rh)).numpy(),
        np.asarray(jrs.relskew_ratio(jnp.asarray(hw), jnp.asarray(rh))),
        **TOL)
    for a, b in zip(prs.relskew_weight(t(hw), t(rh)),
                    jrs.relskew_weight(jnp.asarray(hw), jnp.asarray(rh))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("with_skew", [False, True])
def test_flip_scorer_matches(with_skew):
    rng = np.random.default_rng(5)
    B, M, T = 8, 12, 128
    parts = [rng.normal(0, 50, (5, M, T)), rng.normal(0, 50, (3, M, T))]
    parts[0][0, 0, 0] = np.nan
    parts[1][1, 2, 3] = -np.inf
    pat = np.stack([(np.arange(T) & rng.integers(0, T)) for _ in range(B)])
    allowed = rng.random((B, T)) < 0.7
    hw, rh = rng.uniform(0.01, 0.99, (B, M)), rng.uniform(0.1, 0.9, (B, M))
    hc = rng.integers(0, 3, (B, M)).astype(float)
    hb = hc * rng.uniform(0, 1, (B, M))
    desc = rng.integers(1, 4, B).astype(float)
    tsel = (np.arange(T) & 64) > 0
    k = 5
    got = ppf.make_flip_scorer()(
        [t(p) for p in parts], t(pat, torch.int64), t(allowed), t(hw), t(rh),
        t(hb), t(hc), t(desc), t(tsel), k=k, with_skew=with_skew)
    ref = jpf.make_flip_scorer()(
        tuple(jnp.asarray(p) for p in parts), jnp.asarray(pat),
        jnp.asarray(allowed), *(jnp.asarray(x) for x in (hw, rh, hb, hc,
                                                          desc, tsel)),
        k=k, with_skew=with_skew)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_array_equal(np.isinf(g), np.isinf(r))
        fin = np.isfinite(r)
        np.testing.assert_allclose(g[fin], r[fin], rtol=1e-10, atol=1e-9)


def test_apply_flips_on_tensors():
    from cnf2freq_tpu.utils import simulate_f2
    from cnf2freq_tpu_torch import copy_pedigree
    ped = simulate_f2(n_f2=3, n_markers=6, seed=6)
    ped2 = copy_pedigree(ped)
    rng = np.random.default_rng(6)
    NI = len(ped.inds) - 1
    hb = rng.uniform(0, 1, (NI, 6))
    hc = hb + 1.0
    win = ppf.FlipCandidate(score=1.0, cover={ped.dous[0]},
                            flips=[(ped.dous[0], 2)])
    idx = {n: n - 1 for n in range(1, NI + 1)}
    hbt, hct = t(hb), t(hc)
    ppf.apply_flips(ped, win, 0, hbt, hct, idx)
    jwin = jpf.FlipCandidate(score=1.0, cover=win.cover, flips=win.flips)
    jpf.apply_flips(ped2, jwin, 0, hb, hc, idx)
    np.testing.assert_array_equal(hbt.numpy(), hb)
    for a, b in zip(ped.inds[1:], ped2.inds[1:]):
        np.testing.assert_array_equal(a.haploweight, b.haploweight)
        assert a.lastinved == b.lastinved
