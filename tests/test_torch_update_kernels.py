"""The update stage's kernel entries on CPU tensors against the JAX
package (float64, inputs from a numpy seed with edge lanes,
tests/torch_update_util.py): ``capped_haplo`` through
``update_haploweights``, ``capped_infprob`` through ``update_infprobs``
and ``relskew_ratio``, at rtol 1e-9 / atol 1e-12 with equal hits.  On the
CPU each entry runs its plain version and counts no launch; the card's
kernels (csrc/capped.cu, csrc/relskew.cu) are held to the plain versions
by tests/test_torch_kernels_cuda.py.

Every lane is active, so every value an entry returns is compared.  The
edge lanes: scalefactor 0, flat lanes, NaN gradients, current values at
eps and 1 - eps, breakathalf moves, lanes without mass, relskew rows
whose mass is rescaled; M in {1, 11} for the capped entries (one JAX
while-loop compile each) and {1, 2, 11} for the relskew HMM.  The JAX
package runs with the port's flat-lane rule patched in (test-side only,
``torch_port_util.freezing_flat``); the flat lanes it freezes are counted
and must occur.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import freezing_flat, t
from torch_update_util import (FLAT_OFFSETS, forward_rescales, haplo_inputs,
                               infprob_inputs, relskew_inputs)

from cnf2freq_tpu.config import RuntimeParams
from cnf2freq_tpu.updates import capped as jcap
from cnf2freq_tpu.updates import parameter_updates as jpu
from cnf2freq_tpu.updates import relskew as jrs
from cnf2freq_tpu_torch.updates import capped as pcap
from cnf2freq_tpu_torch.updates import parameter_updates as ppu
from cnf2freq_tpu_torch.updates import relskew as prs

TOL = dict(rtol=1e-9, atol=1e-12)
PARAMS = RuntimeParams()
CAPPED_CU = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cnf2freq_tpu_torch", "csrc", "capped.cu")


@pytest.fixture
def port(monkeypatch):
    """The JAX package with the port's flat-lane rule; the port's entries
    recorded as update_* calls them, its flat lanes counted and the launch
    counters zeroed."""
    monkeypatch.setattr(jpu, "cappedgd", freezing_flat(jcap))
    seen = {"calls": [], "flat": 0}
    for name in ("capped_haplo", "capped_infprob"):
        real = getattr(pcap, name)
        real.launches = 0

        def recording(*args, real=real, name=name):
            out = real(*args)
            seen["calls"].append((name, args, out))
            return out
        monkeypatch.setattr(ppu, name, recording)
    real_flat = pcap.flat_lanes

    def counting(g0):
        m = real_flat(g0)
        seen["flat"] += int(m.sum())
        return m
    monkeypatch.setattr(pcap, "flat_lanes", counting)
    prs.relskew_ratio.launches = 0
    yield seen
    assert pcap.capped_haplo.launches == 0
    assert pcap.capped_infprob.launches == 0
    assert prs.relskew_ratio.launches == 0


@pytest.mark.parametrize("sf", [0.013, 0.0])
@pytest.mark.parametrize("M", [1, 11])
def test_capped_haplo_matches_jax(port, M, sf):
    args = haplo_inputs(M=M)
    got = ppu.update_haploweights(*(t(x) for x in args), PARAMS, sf)
    ref = jpu.update_haploweights(*(jnp.asarray(x) for x in args), PARAMS,
                                  sf)
    ((name, lanes, (v, hit)),) = port["calls"]
    assert name == "capped_haplo"
    np.testing.assert_allclose(v.numpy(), np.asarray(ref.haploweight), **TOL)
    np.testing.assert_allclose(got.haploweight.numpy(),
                               np.asarray(ref.haploweight), **TOL)
    assert int(hit.sum()) == int(got.hits) == int(ref.hits)
    # the edges occur: flat lanes (row 2, offset FLAT_OFFSETS[0]), lanes at
    # eps and 1 - eps, NaN gradients
    assert port["flat"] >= M
    w, eps = lanes[0], lanes[6]
    assert bool((w[0] == eps[0]).all() and (w[1] == 1.0 - eps[1]).all())
    assert abs(float(w[2, 0]) - 0.5 - FLAT_OFFSETS[0]) < 1e-15
    assert bool(torch.isnan(lanes[4][4]).all())
    if sf:
        assert int(got.hits) > 0
        # rows 5 and 6 cross 0.5 without breakathalf and stop short of it
        # with it
        free, _ = pcap.capped_haplo_reference(
            *lanes[:7], torch.zeros_like(lanes[7]), *lanes[8:])
        side = (w[5:7] - 0.5).sign()
        assert bool(((free[5:7] - 0.5).sign() != side).any())
        assert bool(((v[5:7] - 0.5).sign() == side).all())
    else:
        # scalefactor 0: every lane keeps its capped starting value
        still, _ = pcap.caplogitchange(w, w, eps[:, None].expand_as(w),
                                       lanes[7])
        np.testing.assert_array_equal(v.numpy(), still.numpy())


@pytest.mark.parametrize("sf", [0.013, 0.0])
@pytest.mark.parametrize("M", [1, 11])
def test_capped_infprob_matches_jax(port, M, sf):
    args = infprob_inputs(M=M)
    got = ppu.update_infprobs(*(t(x) for x in args), PARAMS, sf)
    ref = jpu.update_infprobs(*(jnp.asarray(x) for x in args), PARAMS, sf)
    ((name, lanes, (v, hit)),) = port["calls"]
    assert name == "capped_infprob"
    np.testing.assert_allclose(v.numpy(), np.asarray(ref.newprob), **TOL)
    np.testing.assert_allclose(got.newprob.numpy(),
                               np.asarray(ref.newprob), **TOL)
    assert int(hit.sum()) == int(got.hits) == int(ref.hits)
    cp, a, tot, eps = lanes[0], lanes[1], lanes[2], lanes[4]
    live = a > 0
    # lanes without mass (row 4 entirely) are 0 and never hit
    assert bool((~live[4]).all())
    assert not bool((v[~live] != 0).any() or hit[~live].any())
    # flat lanes, current probabilities at eps and 1 - eps, NaN totals
    assert port["flat"] >= 2 * M
    assert bool(((cp[0] == eps[0]) | (cp[0] == 1.0 - eps[0])).all())
    assert bool(torch.isnan(tot[3]).all() and live[3, ..., 1].all())
    if sf:
        assert int(got.hits) > 0


@pytest.mark.parametrize("M", [1, 2, 11])
def test_relskew_ratio_matches_jax(port, M):
    hw, rh = relskew_inputs(M=M)
    if M == 11:
        # rows 0 and 1 rescale their mass
        assert forward_rescales(hw, rh)[:2].all()
    # a chromosome's columns of a wider cohort tensor, as the callers pass
    wide_hw = np.concatenate([hw, np.full((hw.shape[0], 3), 0.25)], axis=1)
    wide_rh = np.concatenate([rh, np.full((rh.shape[0], 3), 0.75)], axis=1)
    got = prs.relskew_ratio(t(wide_hw)[:, :M], t(wide_rh)[:, :M])
    ref = jrs.relskew_ratio(jnp.asarray(hw), jnp.asarray(rh))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        got.numpy(), prs.relskew_ratio_reference(t(hw), t(rh)).numpy())
    assert bool(torch.isfinite(got).all())


def test_gauss_legendre_literals():
    """csrc/capped.cu's node and weight literals are the plain form's
    np.polynomial.legendre.leggauss(15) values exactly."""
    src = open(CAPPED_CU).read()
    for name, ref in (("kGlX", pcap._GL_X), ("kGlW", pcap._GL_W)):
        body = re.search(name + r"\[kNodes\] = \{(.*?)\};", src, re.S)
        vals = np.array([float(x) for x in body.group(1).split(",")])
        np.testing.assert_array_equal(vals, ref)
