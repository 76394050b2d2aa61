"""The port's cohort-imputation example
(``cnf2freq_tpu_torch/examples/impute_cohort.py``) against the JAX
package's ``examples/impute_cohort.py``, piece by piece (numpy only, no
JAX compile).

* Its inputs: the port's ``simulate_f2(seed=42, missing_rate=0.05,
  error_rate=0.01)`` and ``mask_markers(every=7)`` at 12 x 16 give the
  same pedigree arrays and held-out truth as the JAX package's.
* ``main([... "--device", "cpu"])`` at 12 x 16 with 2 iterations masks
  the JAX example's cohort, returns the JAX example's exit rule applied to
  the score it prints, and writes three non-empty files.
* Its genotype and line-origin tables are byte for byte what the JAX
  package's writers (``cnf2freq_tpu.io.outputs``) write from the same
  port pedigree, pair tables and line-origin tables, and its dump parses
  (``utils.refparity.parse_dump``) back into the pedigree's state within
  the dump's rounding.
* ``--device cuda`` without a card raises the Driver's error and writes
  nothing.

The JAX example itself is not run: it compiles the JAX Driver's programs
(76 s on one CPU core at 12 x 16 with 2 iterations, against 9 s for the
port's).  The Driver inside the port's example is
held to the JAX Driver by tests/test_torch_driver.py and
``tests/torch_port_util.run_pair``.
"""
import ast
import io
import os

import numpy as np
import pytest
import torch
from torch_port_util import DUMP_ATOL

from cnf2freq_tpu.io import outputs as jout
from cnf2freq_tpu.utils import harness as jharness
from cnf2freq_tpu.utils.simulate import simulate_f2 as jax_simulate
from cnf2freq_tpu_torch.examples import impute_cohort as ex
from cnf2freq_tpu_torch.utils import refparity as prp
from cnf2freq_tpu_torch.utils.harness import mask_markers
from cnf2freq_tpu_torch.utils.simulate import simulate_f2

SIZE = dict(f2=12, markers=16, iters=2, mask_every=7)
# the example's simulate_f2 call at that size
COHORT = dict(n_f2=12, n_markers=16, missing_rate=0.05, error_rate=0.01,
              seed=42)
KINDS = ("genotypes", "dump", "lineorigin")


def jax_exit_rule(score):
    """examples/impute_cohort.py's return value."""
    return 0 if score["accuracy"] > 0.9 else 1


def argv(prefix, device="cpu"):
    return ["--f2", "12", "--markers", "16", "--iters", "2",
            "--device", device, "--out-prefix", prefix]


def test_inputs_match_jax():
    port, jax = simulate_f2(**COHORT), jax_simulate(**COHORT)
    held = {"port": mask_markers(port, every=7),
            "jax": jharness.mask_markers(jax, every=7)}
    assert held["port"].masked == held["jax"].masked
    assert held["port"].truth == held["jax"].truth
    assert len(held["port"].masked) > 0
    np.testing.assert_array_equal(port.markerposes, jax.markerposes)
    assert list(port.chromstarts) == list(jax.chromstarts)
    assert list(port.dous) == list(jax.dous)
    assert len(port.inds) == len(jax.inds)
    for a, b in zip(port.inds[1:], jax.inds[1:]):
        for f in ("n", "name", "gen", "founder", "has_prior"):
            assert getattr(a, f) == getattr(b, f), f
        assert list(a.pars) == list(b.pars)
        for f in ("markerdata", "markersure", "priormarkerdata",
                  "priormarkersure"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


def test_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    from cnf2freq_tpu_torch.utils import harness
    seen = []
    real_mask = harness.mask_markers

    def recording_mask(ped, **kw):
        res = real_mask(ped, **kw)
        seen.append((res, [i.markerdata.copy() for i in ped.inds[1:]]))
        return res
    monkeypatch.setattr(harness, "mask_markers", recording_mask)
    prefix = str(tmp_path / "demo")
    rc = ex.main(argv(prefix))
    err = capsys.readouterr().err
    # the example masked the JAX example's cohort
    jax = jax_simulate(**COHORT)
    jheld = jharness.mask_markers(jax, every=7)
    (res, masked), = seen
    assert res.truth == jheld.truth
    for a, b in zip(masked, jax.inds[1:]):
        np.testing.assert_array_equal(a, b.markerdata)
    line = [ln for ln in err.splitlines() if ln.startswith("recovery: ")]
    assert len(line) == 1
    score = ast.literal_eval(line[0][len("recovery: "):])
    assert score["total"] > 0
    assert rc == jax_exit_rule(score) == ex.exit_code(score)
    assert [ln.split(":")[0] for ln in err.splitlines()
            if ln.startswith("iter ")] == ["iter 0", "iter 1"]
    for k in KINDS:
        assert os.path.getsize(f"{prefix}.{k}") > 0, k


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("impute") / "demo")
    score, paths, drv = ex.impute_cohort(out_prefix=prefix, device="cpu",
                                         **SIZE)
    return score, paths, drv


def test_tables_match_jax_writers(run):
    _, paths, drv = run
    assert paths == {k: paths["dump"][:-len("dump")] + k for k in KINDS}
    for name, write, tables in (
            ("genotypes", jout.write_genotype_table, drv.pair_tables),
            ("lineorigin", jout.write_line_origin_table,
             drv.line_origin_tables())):
        want = io.StringIO()
        write(drv.ped, tables, want)
        with open(paths[name]) as f:
            got = f.read()
        assert got and got == want.getvalue(), name


def test_dump_round_trip(run):
    _, paths, drv = run
    with open(paths["dump"]) as f:
        blocks = prp.parse_dump(f.read(), drv.ped.num_markers)
    assert len(blocks) == 1
    dev = prp.compare(blocks[0], prp.state_from_pedigree(drv.ped))
    assert dev["genotype_mismatches"] == 0, dev
    for col in ("haploweight", "markersure", "relhaplo"):
        assert dev[col] <= DUMP_ATOL, dev


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prefix = str(tmp_path / "demo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(argv(prefix, device="cuda"))
    assert os.listdir(tmp_path) == []
