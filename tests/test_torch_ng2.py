"""The 4-state (numgen == 2, haplotyping) engine of the port against the
JAX package's, and the 4-state sweeps against the JAX XLA scans.

* Engine functions (``engine_ng2``): ``embed7``, the blocks,
  ``assemble_e_ng2``, the phase-resolved emissions, the haplo and infprob
  statistics, ``coherence_slot_ng2``, ``chromosome_scan_ng2`` with and
  without coherence and the merged scan against the JAX functions at
  rtol 1e-10, float64, on the half-sib cohort of tests/test_engine_ng2.py
  (rebuilt here) and on simulate_f2(12, 16) with numgen=2 and randomised
  haploweights and error rates.
* Sweeps: ``ops.fb.fb_sweeps_reference`` at the XLA scan's clip (1e-300)
  against the JAX package's ``forward_backward(use_pallas=False)`` and
  ``ops.scan_v2.fb_scan_v2`` (X layout) at NS = 1 and NS = 2; in float32
  the clip constant is 0 in both packages (``p < 1e-300`` keeps 1e-35),
  so a float32 sweep whose carry falls below 1e-30 keeps it.
* Driver: the port's Driver against the JAX Driver (``run_pair``, the
  port's rules patched into the JAX side), 3 iterations, float64, on a
  simulate_f2(12, 16) cohort with numgen=2 and the F1 parents typed from
  the simulated truth, on the resident iteration and with resident=False;
  state, pair tables and iteration records at rtol 1e-8.
* Refusals: parity mode raises before any work, and so does a
  marker-blocked nohaplo chromosome; a marker-blocked ng2 or
  extended-space chromosome runs; the extended spaces construct.
"""
import numpy as np
import pytest
import torch
from torch_port_util import (check_anchor_departures, check_iterations,
                             jax_batch, run_pair, t, torch_batch)

from cnf2freq_tpu_torch import Driver
from cnf2freq_tpu_torch import config as pconfig
from cnf2freq_tpu_torch import engine_ng2 as P
from cnf2freq_tpu_torch.hmm.family import gather_family
from cnf2freq_tpu_torch.ops import fb as pfb
from cnf2freq_tpu_torch.pedigree import from_host

RTOL, ATOL = 1e-10, 1e-13


def _jax():
    import jax.numpy as jnp

    from cnf2freq_tpu import engine_ng2 as J
    from cnf2freq_tpu.config import ModelConfig, RuntimeParams
    return jnp, J, ModelConfig, RuntimeParams


def half_sib_ped(M=8, seed=2):
    """Two half-sib trio families sharing parent 'pB': kids k0, k1 from
    (pA, pB); k2 from (pC, pB) (tests/test_engine_ng2.py's cohort)."""
    from cnf2freq_tpu import ModelConfig, Pedigree
    rng = np.random.default_rng(seed)
    ped = Pedigree(ModelConfig(numgen=2))
    ped.markerposes = np.linspace(0, 70, M)
    ped.chromstarts = [0, M]
    names = ["pA", "pB", "pC", "k0", "k1", "k2"]
    by = {nm: ped.getind(nm) for nm in names}
    by["k0"].pars = (by["pA"].n, by["pB"].n)
    by["k1"].pars = (by["pA"].n, by["pB"].n)
    by["k2"].pars = (by["pC"].n, by["pB"].n)
    for k in ("k0", "k1", "k2"):
        by[k].gen = 2
    ped.dous = [by["k0"].n, by["k1"].n, by["k2"].n]
    ped.freeze()
    for ind in ped.inds[1:]:
        ind.empty = False
        ind.markerdata[:] = rng.integers(1, 3, (M, 2))
        ind.markersure[:] = 0.02
        ind.haploweight[:] = rng.uniform(0.25, 0.75, M)
    by["k0"].markerdata[3] = 0
    by["k0"].markersure[3] = 0.0
    by["k2"].markerdata[5, 1] = 0
    by["k2"].markersure[5, 1] = 0.0
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_children()
    ped.count_descendants()
    return ped


def f2_ped(seed=7, typed=True):
    """simulate_f2(12, 16) under numgen=2; ``typed`` gives the F1 parents
    their simulated genotypes (with a 0.02 error rate), so that the
    parents' leaves carry information."""
    from cnf2freq_tpu.config import ModelConfig
    from cnf2freq_tpu.utils.simulate import simulate_f2
    ped = simulate_f2(n_f2=12, n_markers=16, n_founder_pairs=2, seed=seed)
    ped.config = ModelConfig(numgen=2)
    if typed:
        for ind in ped.inds[1:]:
            if ind.empty and ind.n in ped.truths:
                ind.markerdata[:] = ped.truths[ind.n]
                ind.markersure[:] = 0.02
                ind.empty = False
    return ped


def _batches(name):
    """(numpy batch, dists, JAX pedigree) of a cohort, with the f2
    cohort's haploweights and error rates randomised."""
    ped = half_sib_ped() if name == "halfsib" else f2_ped(typed=False)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(from_host(ped), list(ped.dous), 0,
                       ped.num_markers - 1)
    if name == "f2":
        rng = np.random.default_rng(3)
        fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
        fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape),
                         fb.ms)
    return fb, np.diff(ped.markerposes), ped


def _close(got, ref, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(ref, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=err_msg)


@pytest.fixture(scope="module", params=["halfsib", "f2"])
def ng2_inputs(request):
    jnp, J, JCfg, JParams = _jax()
    fb, dists, ped = _batches(request.param)
    return dict(fb_np=fb, fbj=jax_batch(fb), fbt=torch_batch(fb),
                dists=dists, jcfg=JCfg(numgen=2), pcfg=pconfig.ModelConfig(
                    numgen=2), jparams=JParams(),
                pparams=pconfig.RuntimeParams(), ped=ped)


def test_embed7_and_blocks(ng2_inputs):
    jnp, J, _, _ = _jax()
    x = ng2_inputs
    j7, p7 = J.embed7(x["fbj"]), P.embed7(x["fbt"])
    for f in ("md", "ms", "hw", "exists", "attop", "flag2ignore",
              "shiftignore", "slot_ind"):
        np.testing.assert_array_equal(getattr(p7, f).numpy(),
                                      np.asarray(getattr(j7, f)), err_msg=f)
    for ci in (True, False):
        jb = J.ng2_blocks(x["fbj"], x["jcfg"], ci=ci)
        pb = P.ng2_blocks(x["fbt"], x["pcfg"], ci=ci)
        _close(pb[0], jb[0])
        for k in range(2):
            _close(pb[1][k], jb[1][k])
        _close(pb[2], jb[2])
        e_j = J.assemble_e_ng2(*jb, x["fbj"], x["jcfg"])
        e_p = P.assemble_e_ng2(*pb, x["fbt"], x["pcfg"])
        _close(e_p, e_j)
    # (the scan's blocks, ci=False)
    for slot in range(3):
        _close(P.phase_resolved_emission_ng2(*pb, x["fbt"], x["pcfg"], slot),
               J.phase_resolved_emission_ng2(*jb, x["fbj"], x["jcfg"], slot))
    np.testing.assert_array_equal(
        P.haplo_update_mask_ng2(x["fbt"], x["pcfg"]).numpy(),
        np.asarray(J.haplo_update_mask_ng2(x["fbj"], x["jcfg"])))


@pytest.mark.parametrize("with_coherence", [False, True])
def test_chromosome_scan_ng2(ng2_inputs, with_coherence):
    """The scan (sweeps, totals, statistics, turn weights and, with
    coherence, every slot's coherence) and its statistics functions on
    the same posterior; coherence_slot_ng2 per slot from the sweeps."""
    jnp, J, _, _ = _jax()
    x = ng2_inputs
    d = x["dists"]
    rj = J.chromosome_scan_ng2(x["fbj"], jnp.asarray(d), x["jcfg"],
                               x["jparams"], with_coherence=with_coherence)
    rp = P.chromosome_scan_ng2(x["fbt"], torch.as_tensor(d), x["pcfg"],
                               x["pparams"], with_coherence=with_coherence)
    for f in rj._fields:
        if f == "haplo_mask":
            np.testing.assert_array_equal(rp.haplo_mask.numpy(),
                                          np.asarray(rj.haplo_mask))
            continue
        _close(getattr(rp, f), getattr(rj, f), err_msg=f)
    if not with_coherence:
        return
    for slot in range(3):
        cj = J.coherence_slot_ng2(x["fbj"], jnp.asarray(d), rj.fw_pre,
                                  rj.bw, rj.fw_pre_f, rj.bw_f, x["jcfg"],
                                  x["jparams"], slot)
        cp = P.coherence_slot_ng2(x["fbt"], torch.as_tensor(d), rp.fw_pre,
                                  rp.bw, rp.fw_pre_f, rp.bw_f, x["pcfg"],
                                  x["pparams"], slot)
        _close(cp, cj)
        _close(rp.coherence[..., slot], cj)


def test_statistics_ng2(ng2_inputs):
    """haplo_stats_ng2 and infprob_stats_ng2 (with and without ci) on one
    posterior W made with numpy."""
    jnp, J, _, _ = _jax()
    x = ng2_inputs
    B, _, M, _ = x["fb_np"].md.shape
    W = np.random.default_rng(4).uniform(0.0, 1.0, (B, M, 2, 4))
    jb = J.ng2_blocks(x["fbj"], x["jcfg"])
    pb = P.ng2_blocks(x["fbt"], x["pcfg"])
    _close(P.haplo_stats_ng2(t(W), pb[0], pb[1], x["fbt"], x["pcfg"]),
           J.haplo_stats_ng2(jnp.asarray(W), jb[0], jb[1], x["fbj"],
                             x["jcfg"]))
    for ci in (False, True):
        ij = J.infprob_stats_ng2(jnp.asarray(W), jb[0], jb[1], x["fbj"],
                                 x["jcfg"], ci=ci)
        ip = P.infprob_stats_ng2(t(W), pb[0], pb[1], x["fbt"], x["pcfg"],
                                 ci=ci)
        _close(ip[0], ij[0])
        _close(ip[1], ij[1])


def test_scan_merged_ng2(ng2_inputs):
    """The merged scan against make_jitted_scan_merged_ng2: the scan's
    fields and the merged accumulators."""
    jnp, J, _, _ = _jax()
    x = ng2_inputs
    ped = x["ped"]
    ids = [ind.n for ind in ped.inds[1:]]
    NI = len(ids)
    lut = np.full(max(ids) + 1, NI, dtype=np.int32)
    lut[ids] = np.arange(NI)
    d = x["dists"]
    rm = np.full((len(d), 2), x["jparams"].baserec)
    run = J.make_jitted_scan_merged_ng2(x["jcfg"], x["jparams"], NI)
    rj, hbj, hcj, infj = run(x["fbj"], jnp.asarray(d), jnp.asarray(lut),
                             jnp.asarray(rm))
    rp, hbp, hcp, infp = P.scan_merged_ng2(
        x["fbt"], torch.as_tensor(d), torch.as_tensor(lut),
        torch.as_tensor(rm), x["pcfg"], x["pparams"], NI)
    for f in ("total", "haplo_b12", "inf_accum", "pair", "turn_weight",
              "coherence", "fw_pre", "bw"):
        _close(getattr(rp, f), getattr(rj, f), err_msg=f)
    for a, b in ((hbp, hbj), (hcp, hcj), (infp, infj)):
        _close(a, b)


# ---------------------------------------------------------------------------
# The 4-state sweeps against the JAX XLA scans
# ---------------------------------------------------------------------------
def _sweep_inputs(NS, M=13, seed=5):
    rng = np.random.default_rng(seed)
    e = rng.uniform(0.0, 1.0, (9, M, NS, 4))
    e[rng.random(e.shape) < 0.2] = 0.0
    e[rng.random((9, M, NS)) < 0.1] = 0.0
    dists = rng.uniform(0.5, 20.0, M - 1)
    return e, dists


@pytest.mark.parametrize("NS", [1, 2])
def test_sweeps_match_xla_scans(NS):
    """fb_sweeps_reference at the XLA scan's clip against the JAX
    package's forward_backward(use_pallas=False) and fb_scan_v2 (X
    layout, batch on the lane axis), float64."""
    jnp, _, JCfg, JParams = _jax()
    from cnf2freq_tpu.hmm.forward_backward import forward_backward
    from cnf2freq_tpu.ops.scan_v2 import fb_scan_v2
    jcfg = JCfg(numgen=2) if NS == 2 else JCfg(
        numgen=2, haplotyping=False, relskews=False, do_infprobs=False)
    pcfg = pconfig.ModelConfig(**{f: getattr(jcfg, f) for f in (
        "numgen", "haplotyping", "relskews", "do_infprobs")})
    e, dists = _sweep_inputs(NS)
    B, M = e.shape[:2]
    from cnf2freq_tpu_torch.hmm.forward_backward import \
        forward_backward as port_fb
    got = port_fb(t(e), t(dists), pcfg, pconfig.RuntimeParams())
    ref = forward_backward(jnp.asarray(e), jnp.asarray(dists), jcfg,
                           JParams(), use_pallas=False)
    for f in ref._fields:
        _close(getattr(got, f), getattr(ref, f), err_msg=f)
    R = 128
    e_x = np.zeros((M, NS * 4, R))
    e_x[:, :, :B] = np.transpose(e, (1, 2, 3, 0)).reshape(M, NS * 4, B)
    v2 = fb_scan_v2(jnp.asarray(e_x), jnp.asarray(dists), jcfg, JParams())

    def std(x):
        return np.transpose(np.asarray(x)[:, :, :B], (2, 0, 1)).reshape(
            B, M, NS, -1)
    for f, g in (("fw_pre", got.fw_pre), ("fw_post", got.fw_post),
                 ("bw", got.bw)):
        _close(g, std(getattr(v2, f)), err_msg=f)
    for f, g in (("fw_pre_f", got.fw_pre_f), ("bw_f", got.bw_f)):
        _close(g, std(getattr(v2, f))[..., 0], err_msg=f)


def test_float32_clip_is_zero_in_both_packages():
    """``p < 1e-300`` on a float32 tensor compares against 0 in JAX and in
    PyTorch, so 1e-35 survives; a float32 sweep whose carry falls below
    1e-30 keeps it at the XLA clip and loses it at the TPU kernels'."""
    jnp, _, JCfg, JParams = _jax()
    from cnf2freq_tpu.hmm.forward_backward import (_emit_normalise,
                                                   forward_backward)
    p = np.array([[1e-35, 0.5, 0.25, 0.25]], dtype=np.float32)
    e = np.ones_like(p)
    pj, _ = _emit_normalise(jnp.asarray(p), jnp.asarray(e),
                            jnp.zeros((1,), jnp.float32))
    pp, _, _ = pfb._step(torch.as_tensor(p), torch.zeros(1),
                         torch.as_tensor(e), torch.ones(4), pfb.XLA_CLIP)
    assert float(pj[0, 0]) > 0 and float(pp[0, 0]) > 0
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=1e-6)
    # the TPU kernels' clip is a float32 number: it zeroes the same value
    pz, _, _ = pfb._step(torch.as_tensor(p), torch.zeros(1),
                         torch.as_tensor(e), torch.ones(4), pfb.ZERO_CLIP)
    assert float(pz[0, 0]) == 0.0
    # whole float32 sweeps of both packages agree
    e, dists = _sweep_inputs(2)
    jcfg, pcfg = JCfg(numgen=2), pconfig.ModelConfig(numgen=2)
    ref = forward_backward(jnp.asarray(e, dtype=jnp.float32),
                           jnp.asarray(dists, dtype=jnp.float32), jcfg,
                           JParams(), use_pallas=False)
    from cnf2freq_tpu_torch.hmm.forward_backward import \
        forward_backward as port_fb
    got = port_fb(torch.as_tensor(e, dtype=torch.float32),
                  torch.as_tensor(dists, dtype=torch.float32), pcfg,
                  pconfig.RuntimeParams())
    for f in ref._fields:
        assert getattr(got, f).dtype == torch.float32
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)


# ---------------------------------------------------------------------------
# The Driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "host_gathered"])
def test_driver_matches_jax(resident, record_property):
    kw = {} if resident else dict(resident=False)
    runs = run_pair(f2_ped(), adaptive=True, jax_resident=resident, **kw)
    check_iterations(runs, ("haploweight", "markersure", "relhaplo"))
    check_anchor_departures(runs["seen"]["anchors"])
    j, p = runs["jax"], runs["torch"]
    # the run moved the phases and relhaplo, and the flip stage ran
    assert not np.array_equal(p["post"]["haploweight"],
                              runs["raw"]["haploweight"])
    assert not np.array_equal(p["post"]["relhaplo"], runs["raw"]["relhaplo"])
    assert len(runs["seen"]["scored"]) == 2
    assert [m["hitnnn"] for m in p["metrics"]] == \
        [m["hitnnn"] for m in j["metrics"]]
    record_property("winner_departures", sum(runs["seen"]["winners"]))


def test_refusals():
    """Parity mode is refused for the ng2 family and the extended state
    spaces, which construct; a marker-blocked ng2 or extended-space
    chromosome runs (blocked_families.py), and a blocked nohaplo one is
    refused before any work, as in the JAX Driver; an unblocked
    marker_block runs."""
    ped = from_host(f2_ped())
    with pytest.raises(NotImplementedError, match="parity"):
        Driver(ped, device="cpu", parity=True)
    for cfg in (pconfig.ModelConfig(selfing=True),
                pconfig.ModelConfig(relskewstates=True)):
        p2 = from_host(f2_ped())
        p2.config = cfg
        with pytest.raises(NotImplementedError, match="parity"):
            Driver(p2, device="cpu", parity=True)
        d2 = Driver(p2, device="cpu")
        assert d2.ext
        d2.marker_block = 8
        assert np.isfinite(d2.iterate(early=True)["loglik"])
        assert d2.state.iter == 1
    nh = from_host(f2_ped())
    nh.config = pconfig.F2_NOHAPLO
    dn = Driver(nh, device="cpu")
    dn.marker_block = 8
    with pytest.raises(NotImplementedError, match="deep-walk"):
        dn.iterate(early=True)
    assert dn.state.iter == 0
    d = Driver(ped, device="cpu")
    d.marker_block = 8
    d.preprocess()
    before = [i.haploweight.copy() for i in ped.inds[1:]]
    assert np.isfinite(d.iterate(early=True)["loglik"])
    assert d.state.iter == 1
    d.marker_block = 16
    assert np.isfinite(d.iterate(early=True)["loglik"])
    assert not all(np.array_equal(a, i.haploweight)
                   for a, i in zip(before, ped.inds[1:]))
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1)
    assert fb.md.shape[1] == 3
