"""Shared inputs and harness for the PyTorch-port parity tests
(tests/test_torch_*.py).

Cohorts come from ``simulate_f2`` with a numpy seed; both packages get the
same numpy arrays.  The driver harness (``run_pair`` and its checks) runs
the port's Driver and the JAX package's Driver from one cohort, with the
port's rules patched into the latter (test-side only).  JAX is
imported inside the functions that need it: the card's tests import this
module on a machine without JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cnf2freq_tpu.config import ModelConfig, RuntimeParams
from cnf2freq_tpu.utils.simulate import simulate_f2
from cnf2freq_tpu_torch import Driver, copy_pedigree
from cnf2freq_tpu_torch.driver import LOCK_TIE_RTOL, anchor_marker
from cnf2freq_tpu_torch.hmm.family import FamilyBatch, gather_family
from cnf2freq_tpu_torch.pedigree import from_host
from cnf2freq_tpu_torch.updates import capped
from cnf2freq_tpu_torch.updates import negshift as port_negshift
from cnf2freq_tpu_torch.updates.phaseflip import make_flip_scorer

FLAT_LIMIT = 1.0 / (1e-2 * np.finfo(np.float64).eps ** 0.5)

# the suite runs several pytest workers on one machine's cores; the port's
# tensors in these tests are small, and one torch thread a worker keeps
# the workers' thread pools from spinning against each other (every worker
# imports this module while it collects the tests)
torch.set_num_threads(1)


def cohort(B=6, M=9, seed=3, with_vacant=False):
    """(ped, numpy FamilyBatch, dists, cfg, params) with randomised
    haploweights and error rates, as tests/test_scan_v2.py.  Imports no
    JAX (the card's tests use it too)."""
    ped = simulate_f2(n_f2=B, n_markers=M, n_founder_pairs=2, seed=seed)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    focals = list(ped.dous)
    if with_vacant:
        # F1 focals: founder parents, vacant grandparent slots
        focals += [i.n for i in ped.inds[1:]
                   if i.pars[0] and ped.by_id(i.pars[0]).founder][:2]
    fb = gather_family(ped, focals, 0, ped.num_markers - 1)
    rng = np.random.default_rng(seed)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    dists = np.diff(ped.markerposes).astype(np.float64)
    return ped, fb, dists, ModelConfig(), RuntimeParams()


def flat_unit(fb_np, unit: int):
    """A copy of a numpy batch with every slot of ``unit`` untyped (its
    emission blocks carry no genotype information)."""
    fb = dataclasses.replace(fb_np, md=fb_np.md.copy())
    fb.md[unit] = 0
    return fb


def coherence_edge_sweeps(fbres):
    """The classic sweeps (B >= 3 units, M >= 8 markers) edited at the
    coherence kernel's edges: unit 0's shift 3 carries no mass at any
    marker, unit 1 carries none in any shift at marker 5 (so pair (5, 6)
    has a zero total), and unit 2's backward row at marker 7 is zero
    (pair (6, 7))."""
    from cnf2freq_tpu_torch.config import MINFACTOR
    fw_pre, fw_pre_f = fbres.fw_pre.clone(), fbres.fw_pre_f.clone()
    bw = fbres.bw.clone()
    fw_pre[0, :, 3] = 0.0
    fw_pre_f[0, :, 3] = MINFACTOR
    fw_pre[1, 5] = 0.0
    fw_pre_f[1, 5] = MINFACTOR
    bw[2, 7] = 0.0
    return fbres._replace(fw_pre=fw_pre, fw_pre_f=fw_pre_f, bw=bw)


def boundary_span(fbres, m: int):
    """The marker-blocked scan's stitch of markers (m, m + 1), as
    ``Driver._blocked_followups`` builds it: the forward column of m
    beside a zero one, the backward column of m + 1 beside a ones one."""
    from cnf2freq_tpu_torch.hmm.forward_backward import FBResult
    pfp, pff = fbres.fw_pre[:, m], fbres.fw_pre_f[:, m]
    zero, zero_f = torch.zeros_like(pfp), torch.zeros_like(pff)
    return FBResult(
        fw_pre=torch.stack([pfp, zero], dim=1), fw_post=None,
        bw=torch.stack([torch.ones_like(pfp), fbres.bw[:, m + 1]], dim=1),
        fw_pre_f=torch.stack([pff, zero_f], dim=1), fw_post_f=None,
        bw_f=torch.stack([zero_f, fbres.bw_f[:, m + 1]], dim=1))


def turn_edge_sweeps(fbres, fb):
    """The classic sweeps (B >= 5 units) and torch batch edited at the
    [B, M, NS, S] turn kernel's edges (as the v2 entry's card test): units
    1 and 4 allow shift 0 only; unit 0's D is 0 at offset 0 (every weight
    MINFACTOR), unit 2's D[0] > 0 and D = 0 off offset 0, unit 3's
    D[12] < 0; units 0, 2 and 3 count 2 descendants."""
    fw_post, bw = fbres.fw_post.clone(), fbres.bw.clone()
    fw_post_f, bw_f = fbres.fw_post_f.clone(), fbres.bw_f.clone()
    B, M = fw_post.shape[:2]
    fp, bp = fw_post.view(B, M, 512), bw.view(B, M, 512)
    sh = fb.shiftignore.clone()
    sh[[1, 4]] = 7
    for r in (0, 2, 3):
        fp[r], bp[r] = 0.0, 0.0
        fw_post_f[r], bw_f[r] = 0.0, 0.0
        fp[r, :, 5] = 1.0
        sh[r] = 0
    bp[0, :, 9] = 1.0                 # D nonzero at 5 ^ 9 = 12 only
    bp[2, :, 5] = 1.0                 # D[0] = 1, D = 0 elsewhere
    bp[3, :, 5] = 1.0                 # D[0] = 1, D[12] = -0.5
    bp[3, :, 5 ^ 12] = -0.5
    desc = fb.descendants.clone()
    desc[[0, 2, 3]] = 2
    return fbres._replace(fw_post=fw_post, bw=bw, fw_post_f=fw_post_f,
                          bw_f=bw_f), \
        dataclasses.replace(fb, shiftignore=sh, descendants=desc)


def torch_batch(fb_np, dtype=torch.float64) -> FamilyBatch:
    """CPU tensors of a numpy batch."""
    return fb_np.to("cpu", dtype)


def jax_batch(fb_np):
    """The JAX package's FamilyBatch (jax arrays) of a numpy batch."""
    import jax.numpy as jnp

    from cnf2freq_tpu.hmm.family import FamilyBatch as JaxFamilyBatch
    return JaxFamilyBatch(**{f.name: getattr(fb_np, f.name, None)
                             for f in dataclasses.fields(JaxFamilyBatch)}
                          ).map(jnp.asarray)


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def state(ped):
    inds = ped.inds[1:]
    return {"haploweight": np.stack([i.haploweight for i in inds]),
            "markerdata": np.stack([i.markerdata for i in inds]),
            "markersure": np.stack([i.markersure for i in inds]),
            "relhaplo": np.stack([i.relhaplo for i in inds])}

def _flips(w):
    return None if w is None else sorted(w.flips)


def freezing_flat(jax_capped):
    """The JAX package's ``jax_capped.cappedgd`` with the port's rule 2: a
    lane whose starting inverse gradient is finite and above FLAT_LIMIT
    (``capped.flat_lanes``) keeps its capped starting value."""
    import jax.numpy as jnp
    cappedgd = jax_capped.cappedgd

    def cappedgd_freezing_flat(gradient, orig, epsilon, scalefactor,
                               breakathalf=False, iters=51):
        new, hit = cappedgd(gradient, orig, epsilon, scalefactor,
                            breakathalf, iters)
        eps = jnp.broadcast_to(jnp.asarray(epsilon, orig.dtype), orig.shape)
        brk = jnp.broadcast_to(jnp.asarray(breakathalf, bool), orig.shape)
        origc, _ = jax_capped.caplogitchange(orig, orig, eps, brk)
        g0 = 1.0 / gradient(jnp.clip(origc, eps, 1.0 - eps))
        flat = jnp.isfinite(g0) & (jnp.abs(g0) > FLAT_LIMIT)
        still, still_hit = jax_capped.caplogitchange(origc, orig, eps, brk)
        return jnp.where(flat, still, new), jnp.where(flat, still_hit, hit)
    return cappedgd_freezing_flat


def patch_jax_with_port_rules(mp, seen):
    """The JAX Driver with the port's four rules, recording each choice
    in which a rule departs from the JAX package's own."""
    import cnf2freq_tpu.updates.capped as jax_capped
    import cnf2freq_tpu.updates.negshift as jax_negshift
    import cnf2freq_tpu.updates.parameter_updates as jax_updates
    from cnf2freq_tpu.driver import Driver as JaxDriver

    def lockhaplos(self, ind, c):
        lo, hi = self.ped.chromosome_range(c)
        start = max(lo, ind.lockstart[c] if ind.lockstart[c] < hi else 0)
        seg = ind.variances[start:hi]
        own = None if seg.size == 0 or (seg <= 0).all() \
            else int(np.argmax(seg))
        rule = anchor_marker(seg)
        if own != rule:
            seg_max = float(seg.max())
            seen["anchors"].append((ind.n, own, rule, seg_max,
                                    None if own is None else float(seg[own])))
        Driver._lockhaplos(self, ind, c)

    solve = JaxDriver._solve_scored

    def solve_scored(self, dous, lo, hi, scored, chrom):
        scored = tuple(np.asarray(x) for x in scored)
        own = solve(self, dous, lo, hi, scored, chrom)
        w = solve(self, dous, lo, hi, Driver._canonical_scores(scored),
                  chrom)
        seen["winners"].append(_flips(own) != _flips(w))
        return w

    real_scorer = JaxDriver._jitted_flip_scorer

    def flip_scorer(self):
        own, port = real_scorer(self), make_flip_scorer()

        def score(parts, pat, allowed, hw, rh, hb, hc, desc, tsel, k,
                  with_skew, halo=False, compress=False):
            out = own(parts, pat, allowed, hw, rh, hb, hc, desc, tsel, k=k,
                      with_skew=with_skew, halo=halo, compress=compress)
            if not np.isnan(np.asarray(out[2])).any():
                seen["scored"].append(None)
                return out
            tt = [torch.as_tensor(np.array(x)) for x in
                  (pat, allowed, hw, rh, hb, hc, desc, tsel)]
            tparts = [torch.as_tensor(np.array(p)) for p in parts]

            def full(fn, wrap):
                # every marker, in marker order: gains [B, M], S [B, M, P]
                M = parts[0].shape[1]
                idx, _, g, s = (np.asarray(x) for x in fn(
                    *wrap, k=M, with_skew=with_skew, halo=halo))
                order = np.argsort(idx)
                return g[:, order], s[:, order]

            gj, sj = full(own, (parts, pat, allowed, hw, rh, hb, hc, desc,
                                tsel))
            gp, sp = full(port, [tparts] + tt)
            # the JAX scorer's NaN sits only beside anchored markers, and
            # the port's scores are the JAX scorer's wherever it does not
            # reach
            ok = ~np.isnan(gj)
            M = gj.shape[1]
            anch = np.isin(np.asarray(hw), (0.0, 1.0))
            beside = anch[:, :M].copy()
            beside[:, :anch.shape[1] - 1] |= anch[:, 1:M + 1]
            assert beside[~ok].all()
            np.testing.assert_allclose(gp[ok], gj[ok], rtol=1e-8,
                                       atol=1e-12)
            np.testing.assert_allclose(sp[ok], sj[ok], rtol=1e-8,
                                       atol=1e-12)
            seen["scored"].append((int((~ok).sum()), ok.size,
                                   int((~ok).any(axis=1).sum())))
            res = port(tparts, *tt, k=k, with_skew=with_skew, halo=halo)
            return tuple(x.numpy() for x in res)
        return score

    select = jax_negshift.select_candidates

    def select_candidates(ped, lo, hi, threshold=-1e-10):
        # the port's rule runs on the JAX Pedigree (the same fields)
        own = select(ped, lo, hi, threshold)
        rule = port_negshift.select_candidates(ped, lo, hi, threshold)
        if own != rule:
            seen["negshift_ties"].append((lo, hi, own, rule))
        return rule

    mp.setattr(jax_negshift, "select_candidates", select_candidates)
    mp.setattr(JaxDriver, "_jitted_flip_scorer", flip_scorer)
    mp.setattr(JaxDriver, "_lockhaplos", lockhaplos)
    mp.setattr(JaxDriver, "_solve_scored", solve_scored)
    mp.setattr(jax_updates, "cappedgd", freezing_flat(jax_capped))

def run_pair(base, adaptive: bool, jax_resident: bool = False,
             iters: int = 3, **driver_attrs):
    """Both drivers from the cohort ``base``, each through its own
    preprocess and ``iters`` iterations (the first early): the port's
    Driver on its default iteration, the JAX Driver with
    ``resident=jax_resident``, and ``driver_attrs`` (flip_mode,
    parent_swap, marker_block) set on both.  Each Driver carries its
    package's ``Tracer``; its metric records and span paths are kept."""
    from cnf2freq_tpu.driver import Driver as JaxDriver
    from cnf2freq_tpu.utils.tracing import Tracer as JaxTracer

    from cnf2freq_tpu_torch.utils.tracing import Tracer

    seen = {"anchors": [], "winners": [], "flat": [], "scored": [],
            "negshift_ties": []}
    real_flat = capped.flat_lanes

    def counting_flat(g0):
        m = real_flat(g0)
        seen["flat"].append(int(m.sum()))
        return m

    out = {"seen": seen, "raw": state(base)}
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_with_port_rules(mp, seen)
        mp.setattr(capped, "flat_lanes", counting_flat)
        dj = JaxDriver(copy_pedigree(base), dtype=np.float64)
        dj.resident = jax_resident
        dj.adaptive_relhaplo = adaptive
        dp = Driver(from_host(base), dtype=torch.float64, device="cpu",
                    adaptive_relhaplo=adaptive)
        dj.tracer, dp.tracer = JaxTracer(), Tracer()
        for d in (dj, dp):
            for k, v in driver_attrs.items():
                setattr(d, k, v)
        for name, d in (("jax", dj), ("torch", dp)):
            d.preprocess()
            pre = (state(d.ped), np.stack([i.variances
                                            for i in d.ped.inds[1:]]))
            out[name] = dict(
                pre=pre,
                iters=[d.iterate(early=(i == 0)) for i in range(iters)],
                post=state(d.ped), pairs=d.pair_tables,
                export=d.export_state(), metrics=d.tracer.metrics,
                spans=set(d.tracer.spans))
    return out

def check_iterations(runs, keys):
    """Both drivers end in the same state, iteration by iteration, with
    the same pair tables and exported state."""
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(t["post"]["markerdata"],
                                  j["post"]["markerdata"])
    for key in keys:
        np.testing.assert_allclose(t["post"][key], j["post"][key],
                                   rtol=1e-8, atol=1e-12, err_msg=key)
    for it_t, it_j in zip(t["iters"], j["iters"]):
        assert it_t["hitnnn"] == it_j["hitnnn"]
        assert it_t["inverted"] == it_j["inverted"]
        assert it_t["scalefactor"] == pytest.approx(it_j["scalefactor"],
                                                    rel=1e-12)
    assert set(t["pairs"]) == set(j["pairs"])
    for n in j["pairs"]:
        np.testing.assert_allclose(t["pairs"][n], j["pairs"][n], rtol=1e-8,
                                   atol=1e-12)
    assert t["export"] == pytest.approx(j["export"], rel=1e-12)

def check_anchor_departures(anchors):
    """Where the port's anchor rule chose otherwise than the JAX package,
    the JAX package's choice hung on rounding: its anchor's variance ties
    the maximum up to LOCK_TIE_RTOL, or every variance of the chromosome
    is rounding residue (the rule then anchors none)."""
    for n, own, rule, seg_max, v_own in anchors:
        if rule is None:
            assert seg_max <= 1e-20, (n, seg_max)
        else:
            assert own is not None and v_own >= seg_max * (1 - LOCK_TIE_RTOL)


def check_negshift_run(parent_swap, record_property):
    """The port's negshift Driver against the JAX Driver on its resident
    iteration at 12 x 16 (tests/test_torch_negshift.py)."""
    runs = run_pair(simulate_f2(n_f2=12, n_markers=16), adaptive=True,
                    jax_resident=True, flip_mode="negshift",
                    parent_swap=parent_swap)
    check_iterations(runs, ("haploweight", "markersure", "relhaplo"))
    # both full iterations applied negshift flips
    assert [i["inverted"] for i in runs["torch"]["iters"]] == \
        [False, True, True]
    ties = runs["seen"]["negshift_ties"]
    for lo, hi, own, rule in ties:
        # the same individuals; a moved position ties the minimum
        assert [c[0] for c in own] == [c[0] for c in rule]
        for (_, v_own, _), (_, v_rule, _) in zip(own, rule):
            assert abs(v_rule - v_own) <= \
                max(abs(v_own), 1.0) * port_negshift.NEGSHIFT_TIE_RTOL
    record_property("negshift_tie_departures", len(ties))
    assert len(ties) <= 1
    return runs


# -- the command lines ---------------------------------------------------
# the CLIs' text outputs print 5-6 decimals
CLI_ATOL = 2e-5
# a haplotype dump prints six decimals: half a unit of the sixth, and the
# binary rounding of the printed value
DUMP_ATOL = 5.0000001e-7
OUTPUTS = ("out", "lo", "dump")


def numbers(path):
    """Every number a file prints, in order."""
    out = []
    with open(path) as f:
        for line in f:
            for tok in line.replace(":", " ").split():
                try:
                    out.append(float(tok))
                except ValueError:
                    pass
    return np.array(out)


def assert_same_numbers(a, b):
    x, y = numbers(a), numbers(b)
    assert x.size == y.size and x.size > 0, (a, b)
    np.testing.assert_allclose(x, y, rtol=0, atol=CLI_ATOL, err_msg=a)


def run_jax_cli(argv):
    from cnf2freq_tpu.cli import main as jax_main
    seen = {"anchors": [], "winners": [], "flat": [], "scored": [],
            "negshift_ties": []}
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_with_port_rules(mp, seen)
        return jax_main(argv)
