"""The port's Driver against the JAX package's Driver, and the port's
import boundary.

* preprocess + 3 iterations on simulate_f2(n_f2=12, n_markers=16) (30%
  of genotypes missing, so the correction loop imputes) in float64: the
  port (CPU tensors, plain versions of the kernels) and the JAX Driver
  (resident=False), each from its own preprocess, end with the same
  haploweights, markerdata/markersure, scalefactor and pair tables at
  rtol=1e-8 — once with adaptive_relhaplo=False (the v2 pipeline,
  relhaplo inert) and once with adaptive relhaplo (the default: the
  classic pipeline with coherence, relhaplo compared too).  The port gets
  the cohort through ``pedigree.from_host``.  The port carries three
  rules that the JAX package does not have, so that its choices do not
  hang on rounding (cuda and CPU sum in different orders): phase anchors
  treat variance ties and residues deterministically (``anchor_marker``),
  cappedgd freezes lanes whose gradient is at the rounding floor
  (``flat_lanes``), and flip scores go on a grid before the solve
  (``Driver._canonical_scores``).  The JAX Driver runs with the same
  three rules patched in for this comparison, and every choice in which
  a rule departs from the JAX package is counted and bounded.  A fourth
  difference is the JAX package's: its relskew term guards log(0) with
  the subnormal 1e-323, which XLA CPU flushes to 0, so at an anchored
  marker (haploweight 0 or 1) the term is 0 * -inf = NaN and the family
  drops out of the flip problem there; the port's guard is the smallest
  normal.  Where the JAX scorer returns NaN, the patched JAX Driver takes
  the port's scores: before it does, every (family, marker) score of the
  two scorers is compared, the NaN ones must lie beside an anchored
  marker and all others agree at rtol 1e-8; the NaN entries are counted
  and bounded;
* a subprocess with ``jax`` and ``cnf2freq_tpu`` blocked imports the
  port and runs adaptive-relhaplo iterations on the CPU — the card's
  machine has no JAX, and the port imports nothing of the JAX package;
  no module of the port (nor chip_smoke.py) imports either, by its AST;
* Driver(ped) runs on the card by default and raises on a machine
  without one instead of running on the CPU.
"""
import ast
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnf2freq_tpu.updates.capped as jax_capped
import cnf2freq_tpu.updates.parameter_updates as jax_updates
from cnf2freq_tpu.driver import Driver as JaxDriver
from cnf2freq_tpu.utils import simulate_f2
from cnf2freq_tpu_torch import Driver, copy_pedigree
from cnf2freq_tpu_torch.driver import LOCK_TIE_RTOL, anchor_marker
from cnf2freq_tpu_torch.pedigree import from_host
from cnf2freq_tpu_torch.updates import capped
from cnf2freq_tpu_torch.updates.phaseflip import make_flip_scorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAT_LIMIT = 1.0 / (1e-2 * np.finfo(np.float64).eps ** 0.5)


def _state(ped):
    inds = ped.inds[1:]
    return {"haploweight": np.stack([i.haploweight for i in inds]),
            "markerdata": np.stack([i.markerdata for i in inds]),
            "markersure": np.stack([i.markersure for i in inds]),
            "relhaplo": np.stack([i.relhaplo for i in inds])}


def _flips(w):
    return None if w is None else sorted(w.flips)


def _patch_jax_with_port_rules(mp, seen):
    """The JAX Driver with the port's three rules, recording each choice
    in which a rule departs from the JAX package's own."""
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

    mp.setattr(JaxDriver, "_jitted_flip_scorer", flip_scorer)
    mp.setattr(JaxDriver, "_lockhaplos", lockhaplos)
    mp.setattr(JaxDriver, "_solve_scored", solve_scored)
    mp.setattr(jax_updates, "cappedgd", cappedgd_freezing_flat)


def _run_pair(adaptive: bool):
    """Both drivers from the same simulated cohort, each through its own
    preprocess and three iterations."""
    base = simulate_f2(n_f2=12, n_markers=16)
    seen = {"anchors": [], "winners": [], "flat": [], "scored": []}
    real_flat = capped.flat_lanes

    def counting_flat(g0):
        m = real_flat(g0)
        seen["flat"].append(int(m.sum()))
        return m

    out = {"seen": seen, "raw": _state(base)}
    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_with_port_rules(mp, seen)
        mp.setattr(capped, "flat_lanes", counting_flat)
        dj = JaxDriver(copy_pedigree(base), dtype=np.float64)
        dj.resident = False
        dj.adaptive_relhaplo = adaptive
        dp = Driver(from_host(base), dtype=torch.float64, device="cpu",
                    adaptive_relhaplo=adaptive)
        for name, d in (("jax", dj), ("torch", dp)):
            d.preprocess()
            pre = (_state(d.ped), np.stack([i.variances
                                            for i in d.ped.inds[1:]]))
            out[name] = dict(
                pre=pre, iters=[d.iterate(early=(i == 0)) for i in range(3)],
                post=_state(d.ped), pairs=d.pair_tables,
                export=d.export_state())
    return out


@pytest.fixture(scope="module")
def runs():
    return _run_pair(adaptive=False)


@pytest.fixture(scope="module")
def runs_adaptive():
    return _run_pair(adaptive=True)


def test_preprocess_matches(runs):
    (sj, vj), (st, vt) = runs["jax"]["pre"], runs["torch"]["pre"]
    # the correction loop imputed genotypes, identically
    raw = runs["raw"]["markerdata"]
    assert ((raw == 0) & (st["markerdata"] != 0)).any()
    np.testing.assert_array_equal(st["markerdata"], sj["markerdata"])
    np.testing.assert_allclose(st["markersure"], sj["markersure"],
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(vt, vj, rtol=1e-9, atol=1e-15)
    np.testing.assert_array_equal(st["haploweight"], sj["haploweight"])


def _check_iterations(runs, keys):
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


def test_iterations_match(runs):
    _check_iterations(runs, ("haploweight", "markersure"))
    # relhaplo stays inert
    assert (runs["torch"]["post"]["relhaplo"] == 0.5).all()


def test_adaptive_iterations_match(runs_adaptive):
    """Adaptive relhaplo: the coherence reached relhaplo, identically."""
    _check_iterations(runs_adaptive,
                      ("haploweight", "markersure", "relhaplo"))
    rh = runs_adaptive["torch"]["post"]["relhaplo"]
    assert (rh != 0.5).any()
    assert ((rh >= 1e-4) & (rh <= 1 - 1e-4)).all()


def _check_departures(runs, record_property):
    seen = runs["seen"]
    n_inds = len(runs["jax"]["pre"][1])
    subst = [x for x in seen["scored"] if x is not None]
    for n, own, rule, seg_max, v_own in seen["anchors"]:
        if rule is None:
            assert seg_max <= 1e-20, (n, seg_max)
        else:
            assert own is not None and v_own >= seg_max * (1 - LOCK_TIE_RTOL)
    counts = dict(anchors=len(seen["anchors"]), anchored=n_inds,
                  flat_lanes=sum(seen["flat"]),
                  winners_changed=sum(seen["winners"]),
                  flip_solves=len(seen["winners"]),
                  flip_scorings=len(seen["scored"]),
                  scorings_substituted=len(subst),
                  nan_skew_entries=sum(n for n, _, _ in subst),
                  nan_skew_rows=sum(r for _, _, r in subst),
                  scored_entries=sum(e for _, e, _ in subst))
    record_property("port_rule_departures", counts)
    print("port rule departures:", counts)
    assert counts["anchors"] <= n_inds // 4
    assert counts["winners_changed"] <= 1
    assert counts["flip_solves"] > 0
    # a substituted scoring replaces the JAX scorer's NaN entries only
    # (the rest is held equal above); they stay a small share
    assert counts["scorings_substituted"] <= counts["flip_scorings"]
    assert counts["nan_skew_entries"] * 8 <= counts["scored_entries"]


def test_port_rules_depart_rarely(runs, record_property):
    """Where the port's rules choose otherwise than the JAX package, the
    JAX package's choice hung on rounding: an anchor at a variance tied
    with the maximum up to LOCK_TIE_RTOL, or on a chromosome whose
    variances are all rounding residue."""
    _check_departures(runs, record_property)


def test_adaptive_rules_depart_rarely(runs_adaptive, record_property):
    """As test_port_rules_depart_rarely, with adaptive relhaplo."""
    _check_departures(runs_adaptive, record_property)


def test_chunked_scan_matches_whole():
    """Scanning the units in chunks folds into the same accumulators."""
    base = simulate_f2(n_f2=7, n_markers=6, n_founder_pairs=2, seed=3,
                       missing_rate=0.0)
    out = []
    for bs in (None, 3):
        d = Driver(copy_pedigree(base), device="cpu")
        d.batch_size = bs
        d.preprocess()
        its = [d.iterate(early=(i == 0)) for i in range(2)]
        out.append((its, _state(d.ped), d.pair_tables))
    (ia, sa, pa), (ib, sb, pb) = out
    assert [i["hitnnn"] for i in ia] == [i["hitnnn"] for i in ib]
    for key in sa:
        np.testing.assert_allclose(sb[key], sa[key], rtol=1e-12,
                                   atol=1e-14, err_msg=key)
    for n in pa:
        np.testing.assert_allclose(pb[n], pa[n], rtol=1e-12, atol=1e-14)


def test_import_state_and_copy():
    base = simulate_f2(n_f2=3, n_markers=4, seed=1)
    cp = copy_pedigree(base)
    cp.inds[1].haploweight[:] = 0.25
    assert (base.inds[1].haploweight != 0.25).all()
    d = Driver(cp, device="cpu")
    d.import_state(dict(scalefactor=0.02, oldhitnnn=3, oldhitnnn2=1,
                        iter=4))
    assert d.export_state() == dict(scalefactor=0.02, oldhitnnn=3,
                                    oldhitnnn2=1, iter=4)


def test_adaptive_relhaplo_is_the_default():
    """As in the JAX package (adaptive_relhaplo = not parity)."""
    ped = simulate_f2(n_f2=2, n_markers=3, seed=0)
    assert Driver(ped, device="cpu").adaptive_relhaplo is True
    assert JaxDriver(ped).adaptive_relhaplo is True
    assert not Driver(ped, device="cpu",
                      adaptive_relhaplo=False).adaptive_relhaplo


def test_port_runs_without_jax():
    code = textwrap.dedent("""
        import sys

        BLOCKED = ("jax", "jaxlib", "cnf2freq_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(name + " is blocked")

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        from cnf2freq_tpu_torch import Driver
        from cnf2freq_tpu_torch.utils.simulate import simulate_f2
        ped = simulate_f2(n_f2=3, n_markers=5, seed=2)
        d = Driver(ped, dtype=torch.float64, device="cpu")
        assert d.adaptive_relhaplo
        d.preprocess()
        d.iterate(early=True)
        out = d.iterate()
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        rh = np.stack([i.relhaplo for i in ped.inds[1:]])
        assert (rh != 0.5).any()
        print("OK", out["hitnnn"])
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


def test_cuda_driver_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ped = simulate_f2(n_f2=2, n_markers=3, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Driver(ped, device="cuda")


def test_default_device_is_the_card():
    """Driver(ped) asks for the card; without one it raises."""
    ped = simulate_f2(n_f2=2, n_markers=3, seed=0)
    if torch.cuda.is_available():
        assert Driver(ped).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Driver(ped)


def _imported_modules(path):
    """Top-level names of every module that ``path`` imports (absolute
    imports; relative ones stay inside the package)."""
    tree = ast.parse(open(path).read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (read from the AST, so comments and docstrings do not
    count)."""
    files = [os.path.join(root, f)
             for root, _, fs in os.walk(os.path.join(REPO,
                                                     "cnf2freq_tpu_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    bad = {f: sorted(_imported_modules(f) & {"jax", "jaxlib",
                                             "cnf2freq_tpu"})
           for f in files}
    assert not {f: b for f, b in bad.items() if b}
