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
  port, runs adaptive-relhaplo iterations on the CPU and runs
  ``python -m cnf2freq_tpu_torch --device cpu --count 1`` on a tiny
  written file set — the card's machine has no JAX, and the port imports
  nothing of the JAX package;
  no module of the port (nor chip_smoke.py, nor kernel_ab.py) imports
  either, by its AST;
* Driver(ped) runs on the card by default and raises on a machine
  without one instead of running on the CPU.
"""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_port_util import (check_anchor_departures, check_iterations,
                             run_pair, state)

from cnf2freq_tpu.driver import Driver as JaxDriver
from cnf2freq_tpu.utils import simulate_f2
from cnf2freq_tpu_torch import Driver, copy_pedigree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_pair(adaptive: bool):
    """Both drivers from the same simulated cohort, each through its own
    preprocess and three iterations."""
    return run_pair(simulate_f2(n_f2=12, n_markers=16), adaptive)


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


def test_iterations_match(runs):
    check_iterations(runs, ("haploweight", "markersure"))
    # relhaplo stays inert
    assert (runs["torch"]["post"]["relhaplo"] == 0.5).all()


def test_adaptive_iterations_match(runs_adaptive):
    """Adaptive relhaplo: the coherence reached relhaplo, identically."""
    check_iterations(runs_adaptive,
                      ("haploweight", "markersure", "relhaplo"))
    rh = runs_adaptive["torch"]["post"]["relhaplo"]
    assert (rh != 0.5).any()
    assert ((rh >= 1e-4) & (rh <= 1 - 1e-4)).all()


def _check_departures(runs, record_property):
    seen = runs["seen"]
    n_inds = len(runs["jax"]["pre"][1])
    subst = [x for x in seen["scored"] if x is not None]
    check_anchor_departures(seen["anchors"])
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
        out.append((its, state(d.ped), d.pair_tables))
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

        # python -m cnf2freq_tpu_torch on a tiny written file set
        import os, runpy, tempfile
        from cnf2freq_tpu_torch.utils.simulate import \
            simulate_plantimpute_files
        d = tempfile.mkdtemp()
        m, p, g, _ = simulate_plantimpute_files(d, n_f2=3, n_markers=5)
        out = os.path.join(d, "table.txt")
        sys.argv = ["cnf2freq_tpu_torch", "--mapfile", m, "--pedfile", p,
                    "--genfile", g, "--device", "cpu", "--count", "1",
                    "--output", out, "--dump", os.path.join(d, "dump.txt")]
        try:
            runpy.run_module("cnf2freq_tpu_torch", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert open(out).read().startswith("F2_0:1")
        print("CLI OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")
    assert "CLI OK" in r.stdout


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
    """No module of the port, and neither chip_smoke.py nor kernel_ab.py,
    imports jax or the JAX package (read from the AST, so comments and
    docstrings do not count)."""
    files = [os.path.join(root, f)
             for root, _, fs in os.walk(os.path.join(REPO,
                                                     "cnf2freq_tpu_torch"))
             for f in fs if f.endswith(".py")]
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "kernel_ab.py")]
    assert len(files) > 20
    # parity mode's copied flip stage, the extended engine, the
    # families' blocked scan, the reference-parity harness and the
    # imputation example among them
    for part in (("updates", "refflips.py"), ("engine_ext.py",),
                 ("models", "selfing.py"), ("models", "relskew_states.py"),
                 ("blocked_families.py",), ("utils", "refparity.py"),
                 ("examples", "impute_cohort.py")):
        assert os.path.join(REPO, "cnf2freq_tpu_torch", *part) in files
    bad = {f: sorted(_imported_modules(f) & {"jax", "jaxlib",
                                             "cnf2freq_tpu"})
           for f in files}
    assert not {f: b for f, b in bad.items() if b}
