"""Parity mode in the port (``Driver(parity=True)``) against the JAX package.

Float64 on the CPU, the port's plain PyTorch versions against the JAX
functions (Pallas in interpret mode):
- the probe-rule factors: ``ops.stats._rule_factors_tile`` and
  ``hmm.probes.probe_rule_factors`` against their JAX originals, exactly;
- the probe-rule statistics, ``ops.stats.stats(probe_rules=True,
  n_variants=4)`` against ``scan_v2.stats_from_v2(probe_rules=True,
  n_variants=4, interpret=True)`` on a 12 x 16 batch with four variants
  and tied members (the JAX side on its first 4 markers, for time): rtol
  1e-10 (summation order), and the [B, M, NS, S] form against it;
- ``gather_family(mask_mode="reference", parity=True)`` field by field;
- the parity Driver, ``preprocess()`` then ``run(3)``, against the JAX
  Driver with the port's rounding rules patched in
  (``torch_port_util.patch_jax_with_port_rules``): haploweights,
  markersure and pair tables at rtol 1e-8, the same flip stage inputs
  (turn weights at rtol 1e-8) and the same winner every iteration;
- port only: the blocked parity Driver (marker_block=4) equals the
  unblocked one (as tests/test_blocked.py holds the JAX Driver).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import jax_batch, patch_jax_with_port_rules, state, t

import cnf2freq_tpu.updates.refflips as jax_refflips
from cnf2freq_tpu.hmm import probes as jax_probes
from cnf2freq_tpu.hmm.family import gather_family as jax_gather
from cnf2freq_tpu.ops import scan_v2 as jv2
from cnf2freq_tpu.ops import stats_pallas as jsp
from cnf2freq_tpu.utils.simulate import simulate_f2
from cnf2freq_tpu_torch import Driver, copy_pedigree
from cnf2freq_tpu_torch import driver as port_driver
from cnf2freq_tpu_torch.config import ModelConfig, RuntimeParams
from cnf2freq_tpu_torch.hmm import probes as port_probes
from cnf2freq_tpu_torch.hmm.family import gather_family
from cnf2freq_tpu_torch.ops import scan as ps
from cnf2freq_tpu_torch.ops import stats as pst
from cnf2freq_tpu_torch.pedigree import from_host

CFG = ModelConfig()


def _rule_inputs(n=128, seed=5):
    """Enum-leading slot operands [7, (2,) n] with many duplicate pairs."""
    rng = np.random.default_rng(seed)
    md = rng.integers(0, 3, (7, 2, n)).astype(np.int32)
    md[:, 1] = np.where(rng.random((7, n)) < 0.5, md[:, 0], md[:, 1])
    ms = rng.choice([0.0, 0.01, 0.2], (7, 2, n))
    ms[:, 1] = np.where(rng.random((7, n)) < 0.6, ms[:, 0], ms[:, 1])
    exists = rng.random((7, n)) < 0.8
    empty = (rng.random((7, n)) < 0.2).astype(np.int32)
    dupf = (rng.random((7, n)) < 0.3).astype(np.int32)
    return md, ms, exists, empty, dupf


@pytest.mark.parametrize("with_dupf", [True, False])
def test_rule_factors_tile_match_jax(with_dupf):
    md, ms, exists, empty, dupf = _rule_inputs()
    tile = (8, 16)                    # the JAX tile's two trailing axes

    def jt(x):
        return jnp.asarray(x.reshape(x.shape[:-1] + tile))
    F0j, FPj = jsp._rule_factors_tile(
        jt(md), jt(ms), jt(exists), jt(empty),
        jt(dupf) if with_dupf else None, CFG, jnp.float64)
    F0, FPs = pst._rule_factors_tile(
        t(md), t(ms), t(exists), t(empty), t(dupf) if with_dupf else None,
        CFG, torch.float64)
    np.testing.assert_array_equal(F0.expand(2, 2, 128).numpy(),
                                  np.asarray(F0j).reshape(2, 2, 128))
    for k in range(2):
        np.testing.assert_array_equal(
            FPs[k].expand(8, 8, 2, 128).numpy(),
            np.broadcast_to(np.asarray(FPj[k]),
                            (8, 8, 2) + tile).reshape(8, 8, 2, 128))
        assert (FPs[k] < 0).any() == with_dupf


@functools.lru_cache(maxsize=None)
def _batch():
    """A 12 x 16 parity batch: (ped, numpy FamilyBatch) with four probe
    variants and tied members."""
    ped = simulate_f2(n_f2=12, n_markers=16)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    drv = Driver(from_host(ped), device="cpu", parity=True)
    nv = drv._n_variants()
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1,
                       mask_mode="reference", parity=True, n_variants=nv)
    rng = np.random.default_rng(12)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    return ped, fb, nv


def _tied(fb):
    return (fb.exists[:, :, None] & ~fb.emptyslot[:, :, None]
            & (fb.md[..., 0] == fb.md[..., 1])
            & (fb.ms[..., 0] == fb.ms[..., 1]))


def test_probe_rule_factors_match_jax():
    _, fb, nv = _batch()
    assert nv == 4 and _tied(fb).any()
    fbt = fb.to("cpu", torch.float64)
    fbj = jax_batch(fb)
    for v in range(nv):
        F0j, FPj = jax_probes.probe_rule_factors(fbj, CFG,
                                                     np.dtype("float64"), v)
        F0, FPs = port_probes.probe_rule_factors(fbt, CFG, torch.float64, v)
        np.testing.assert_array_equal(F0.numpy(), np.asarray(F0j))
        for a, b in zip(FPs, FPj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@functools.lru_cache(maxsize=None)
def _stats_case():
    """The 12 x 16 batch in the v2 layout of the JAX package (R = one 1024
    tile) and in the port's SlotTensors holding the same arrays, with the
    port's plain sweeps over them, fed to both packages."""
    ped, fb, nv = _batch()
    B, _, M, _ = fb.md.shape
    st = jv2.prep_slots(jax_batch(fb), jnp.float64)
    R = st.nb * 8 * 128
    sp = ps.SlotTensors(
        md=t(st.md).reshape(7, 2, M, R), ms=t(st.ms).reshape(7, 2, M, R),
        hw=t(st.hw).reshape(7, M, R), ex=t(st.ex).reshape(7, R),
        at=t(st.at).reshape(7, R), f2=t(st.f2).reshape(R),
        sh=t(st.sh).reshape(R), em=t(st.em).reshape(7, R),
        df=t(st.df).reshape(nv, 7, R))
    dists = torch.as_tensor(np.diff(ped.markerposes), dtype=torch.float64)
    fb2 = ps.fb_sweeps(ps.emission(sp, M, CFG), dists, CFG, RuntimeParams())
    total = ps.combined_loglik_v2(fb2, sp.sh)
    return fb, nv, st, sp, fb2, total


def test_stats_probe_rules_match_stats_from_v2():
    fb, nv, st, sp, fb2, total = _stats_case()
    assert nv == 4 and fb.dup_flip.any()
    B, _, M, _ = fb.md.shape
    args = (fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f, total, B, CFG)
    got = pst.stats(sp, *args, probe_rules=True, n_variants=nv)
    plain = pst.stats(sp, *args)
    # interpret-mode Pallas costs ~5 s a call at this size (the JAX package
    # takes ~46 s for all 16 markers), so the JAX side runs on the first K
    # markers: the statistics of a marker depend only on its own slots,
    # sweeps and the totals
    K = 4
    assert _tied(fb)[:, :, :K].any()
    stk = st._replace(md=st.md[:, :, :K], ms=st.ms[:, :, :K],
                      hw=st.hw[:, :K])
    jfb2 = jv2.FBv2(*(jnp.asarray(x[:K].numpy()) for x in fb2))
    ref = jv2.stats_from_v2(stk, jfb2, jnp.asarray(total.numpy()), K, B, CFG,
                            jnp.float64, interpret=True, probe_rules=True,
                            n_variants=nv)
    for name, g, r, p in zip(("b12", "accum", "pair"), got, ref, plain):
        np.testing.assert_allclose(g[:, :K].numpy(), np.asarray(r),
                                   rtol=1e-10, atol=1e-13, err_msg=name)
        # the rules move the statistics
        assert not np.allclose(g.numpy(), p.numpy()), name


def test_stats_bmns_probe_rules_match_v2_layout():
    """The [B, M, NS, S] probe-rule form (``stats_pallas``) on the same
    sweeps equals the v2 layout's."""
    fb, nv, _, sp, fb2, total = _stats_case()
    B = fb.md.shape[0]
    want = pst.stats(sp, fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f, total,
                     B, CFG, probe_rules=True, n_variants=nv)
    got = pst.stats_pallas(
        fb.to("cpu", torch.float64), ps.to_std(fb2.fw_pre, B, CFG),
        ps.to_std(fb2.bw, B, CFG), ps.to_std_f(fb2.fw_pre_f, B),
        ps.to_std_f(fb2.bw_f, B), total[:B], CFG, probe_rules=True,
        n_variants=nv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-15)


def test_gather_family_reference_parity_matches():
    ped = simulate_f2(n_f2=6, n_markers=9, missing_rate=0.3, seed=4)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    # the F2 units and some F1 focals (generation 1: shift truncation)
    focals = list(ped.dous) + [i.n for i in ped.inds[1:] if i.gen == 1][:2]
    kw = dict(mask_mode="reference", parity=True, n_variants=4)
    ref = jax_gather(ped, focals, 0, ped.num_markers - 1, **kw)
    got = gather_family(ped, focals, 0, ped.num_markers - 1, **kw)
    for name in ("md", "ms", "hw", "exists", "attop", "flag2ignore",
                 "shiftignore", "descendants", "slot_ind", "emptyslot",
                 "dup_flip"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)
    young = np.array([ped.by_id(n).gen < 2 for n in focals])
    assert young.any() and (got.shiftignore[young] & 6 == 6).all()
    plain = gather_family(ped, focals, 0, ped.num_markers - 1)
    assert (got.flag2ignore != plain.flag2ignore).any()


def _parity_cohort():
    return simulate_f2(n_f2=5, n_markers=16, missing_rate=0.2,
                       error_rate=0.02, seed=29)


@pytest.fixture(scope="module")
def parity_runs():
    """Both parity Drivers from one cohort through preprocess() and
    run(3), recording every call of their flip stages."""
    from cnf2freq_tpu.driver import Driver as JaxDriver
    base = _parity_cohort()
    seen = {"anchors": [], "winners": [], "flat": [], "scored": [],
            "negshift_ties": []}
    calls = {"jax": [], "torch": []}

    def recording(name, fn):
        def wrapped(ped, cfg, dous, lo, hi, W, hb, hc, ind_index):
            w = fn(ped, cfg, dous, lo, hi, W, hb, hc, ind_index)
            calls[name].append((np.array(W), None if w is None
                                else sorted(w.flips)))
            return w
        return wrapped

    out = {"calls": calls}
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_with_port_rules(mp, seen)
        mp.setattr(jax_refflips, "reference_flips",
                   recording("jax", jax_refflips.reference_flips))
        mp.setattr(port_driver, "reference_flips",
                   recording("torch", port_driver.reference_flips))
        dj = JaxDriver(copy_pedigree(base), dtype=np.float64, parity=True)
        dp = Driver(from_host(base), dtype=torch.float64, device="cpu",
                    parity=True)
        for name, d in (("jax", dj), ("torch", dp)):
            d.preprocess()
            out[name] = dict(iters=d.run(3), post=state(d.ped),
                             pairs=d.pair_tables)
    return out


def test_parity_driver_matches_jax(parity_runs):
    j, p = parity_runs["jax"], parity_runs["torch"]
    assert p["iters"][0] is None and j["iters"][0] is None
    for it_p, it_j in zip(p["iters"][1:], j["iters"][1:]):
        assert it_p["hitnnn"] == it_j["hitnnn"]
        assert it_p["inverted"] == it_j["inverted"]
    np.testing.assert_array_equal(p["post"]["markerdata"],
                                  j["post"]["markerdata"])
    for key in ("haploweight", "markersure"):
        np.testing.assert_allclose(p["post"][key], j["post"][key],
                                   rtol=1e-8, atol=1e-12, err_msg=key)
    # relhaplo is inert in parity mode
    assert (p["post"]["relhaplo"] == 0.5).all()
    assert set(p["pairs"]) == set(j["pairs"])
    for n in j["pairs"]:
        np.testing.assert_allclose(p["pairs"][n], j["pairs"][n], rtol=1e-8,
                                   atol=1e-12)
    cj, cp = parity_runs["calls"]["jax"], parity_runs["calls"]["torch"]
    # one flip stage per full iteration (one chromosome), the same inputs
    # and the same winner each time
    assert len(cp) == len(cj) == 2
    for (wp, win_p), (wj, win_j) in zip(cp, cj):
        fin = np.isfinite(wj)
        np.testing.assert_array_equal(np.isfinite(wp), fin)
        np.testing.assert_allclose(wp[fin], wj[fin], rtol=1e-8, atol=1e-10)
        assert win_p == win_j


def test_blocked_parity_matches_unblocked():
    peds = [_parity_cohort() for _ in range(2)]
    drvs = [Driver(from_host(p), dtype=torch.float64, device="cpu",
                   parity=True) for p in peds]
    drvs[0].marker_block = 4
    assert not drvs[0]._use_resident() and not drvs[1]._use_resident()
    for d in drvs:
        d.preprocess()
        d.iterate(early=True)
        d.iterate(early=False)
    for a, b in zip(drvs[0].ped.inds[1:], drvs[1].ped.inds[1:]):
        np.testing.assert_allclose(a.haploweight, b.haploweight,
                                   rtol=1e-8, atol=1e-11, err_msg=a.name)
    for n in drvs[0].ped.dous:
        np.testing.assert_allclose(drvs[0].pair_tables[n],
                                   drvs[1].pair_tables[n],
                                   rtol=1e-8, atol=1e-11)


def test_parity_refusals():
    d = Driver(from_host(_parity_cohort()), device="cpu", parity=True)
    assert d.mask_mode == "reference" and not d.adaptive_relhaplo
    d.resident = True
    with pytest.raises(ValueError, match="parity"):
        d._use_resident()
