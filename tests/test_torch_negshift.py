"""The port's negshift flip mode and parent-pair swaps against the JAX
package's, on the CPU in float64.

* ``cnf2freq_tpu_torch/updates/negshift.py`` (the port's copy) against
  ``cnf2freq_tpu/updates/negshift.py`` on the same numpy turn weights (a
  seeded normal draw over a two-chromosome simulate_f2 cohort): the
  accumulated negshift sums, the selected candidates and the winner, the
  parent-pair scores, the swap hypotheses and the genome-wide swap moves
  with the haploweights they leave, all equal;
* the port's Driver with ``flip_mode="negshift"`` against the JAX Driver
  on simulate_f2(n_f2=12, n_markers=16) in float64
  (``torch_port_util.run_pair``, the port's rules patched into the JAX
  Driver, among them the negshift tie rule; the JAX Driver forced onto
  its resident iteration, whose programs compile in less time than the
  host-accumulator ones, which the JAX package pins equal to it): the
  same haploweights, markerdata/markersure, relhaplo and pair tables at
  rtol 1e-8, iteration by iteration; every departure of the tie rule
  from the JAX package's exact argmin picks a position whose sum ties
  the minimum.  tests/test_torch_negshift_parentswap.py does the same
  with parent-pair swaps;
* ``python -m cnf2freq_tpu_torch --flipmode negshift --parentswap`` on a
  12 x 16 file set on the CPU completes, writing a genotype block for
  every F2 unit; ``--parentswap`` without ``--flipmode negshift`` exits
  with the JAX CLI's error.

In simulate_f2 cohorts the F1 parents are untyped, so the canonical-path
mask pins their turn bits and no parent-swap hypothesis ever scores (the
Driver runs score nothing to swap); the function-level comparison marks
the F1 parents typed, so that moves are made.
"""
import numpy as np
import pytest
from torch_port_util import check_negshift_run, numbers

import cnf2freq_tpu.updates.negshift as jax_ns
from cnf2freq_tpu.utils import simulate_f2
from cnf2freq_tpu_torch.cli import main as port_main
from cnf2freq_tpu_torch.pedigree import from_host
from cnf2freq_tpu_torch.updates import negshift as port_ns
from cnf2freq_tpu_torch.utils.simulate import simulate_plantimpute_files


@pytest.fixture(scope="module")
def peds():
    """The same two-chromosome cohort in both packages, with the
    structure the negshift pass reads (founder flags, children); the F1
    parents count as typed, so that their turn bits are live."""
    base = simulate_f2(n_f2=10, n_markers=8, n_founder_pairs=2, seed=5,
                       n_chromosomes=2)
    out = {"jax": base, "torch": from_host(base)}
    for ped in out.values():
        for n in ped.dous:
            for p in ped.by_id(n).pars:
                ped.by_id(p).empty = False
        for ind in ped.inds[1:]:
            ped.fixtrees(ind.n)
        ped.count_children(dous_only=True)
        ped.count_descendants()
    return out


def weights(ped, lo, hi, seed):
    """Seeded per-turn log likelihood-ratio sums [B, M, T] (0 at the
    no-turn entry)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 3.0, (len(ped.dous), hi - lo, ped.config.numturns))
    w[:, :, 0] = 0.0
    return w


def test_negshift_pass_matches(peds):
    for c in range(2):
        res = {}
        for name, mod in (("jax", jax_ns), ("torch", port_ns)):
            ped = peds[name]
            lo, hi = ped.chromosome_range(c)
            w = weights(ped, lo, hi, seed=c)
            win = mod.negshift_flips(ped, list(ped.dous), lo, hi, w,
                                     ped.config)
            res[name] = (win, np.stack([i.negshift for i in ped.inds[1:]]),
                         mod.select_candidates(ped, lo, hi))
        (wj, nj, cj), (wt, nt, ct) = res["jax"], res["torch"]
        np.testing.assert_array_equal(nt, nj)
        assert ct == cj and ct
        assert wt.flips == wj.flips and wt.cover == wj.cover
        assert wt.score == wj.score


def test_parent_swaps_match(peds):
    cands, pair_scores = {}, {}
    for name, mod in (("jax", jax_ns), ("torch", port_ns)):
        ped = peds[name]
        cands[name] = []
        for c in range(2):
            lo, hi = ped.chromosome_range(c)
            w = weights(ped, lo, hi, seed=10 + c)
            pair_scores[name, c] = mod.accumulate_pair_scores(
                ped, list(ped.dous), lo, hi, w, ped.config)
            cands[name] += mod.parent_swap_candidates(
                ped, list(ped.dous), lo, hi, w, ped.config)
    for c in range(2):
        pj, pt = pair_scores["jax", c], pair_scores["torch", c]
        assert set(pt) == set(pj)
        for k in pj:
            np.testing.assert_array_equal(pt[k], pj[k])
    assert cands["torch"] == cands["jax"]
    moves = {name: mod.apply_parent_swaps(peds[name], cands[name])
             for name, mod in (("jax", jax_ns), ("torch", port_ns))}
    assert moves["torch"] == moves["jax"] and moves["torch"]
    for a, b in zip(peds["jax"].inds[1:], peds["torch"].inds[1:]):
        np.testing.assert_array_equal(b.haploweight, a.haploweight)


def test_driver_negshift_matches_jax(record_property):
    check_negshift_run(False, record_property)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return simulate_plantimpute_files(str(tmp_path_factory.mktemp("files")),
                                      n_f2=12, n_markers=16, seed=11)[:3]


def _argv(files, d, tag):
    mapfile, pedfile, genfile = files
    return ["--mapfile", mapfile, "--pedfile", pedfile, "--genfile",
            genfile, "--count", "3", "--flipmode", "negshift",
            "--parentswap", "--output", str(d / f"{tag}.out"),
            "--dump", str(d / f"{tag}.dump"),
            "--lineorigin", str(d / f"{tag}.lo")]


def test_cli_negshift_parentswap_completes(files, tmp_path, capsys):
    assert port_main(_argv(files, tmp_path, "port") +
                     ["--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert [ln.split(":")[0] for ln in err.splitlines()
            if ln.startswith("iter ")] == ["iter 0", "iter 1", "iter 2"]
    with open(tmp_path / "port.out") as f:
        assert sum(line.startswith("F2_") for line in f) == 12
    for ext in ("out", "lo", "dump"):
        vals = numbers(str(tmp_path / f"port.{ext}"))
        assert vals.size and np.isfinite(vals).all()


def test_parentswap_needs_negshift(capsys):
    """The JAX CLI's error, from both CLIs."""
    from cnf2freq_tpu.cli import main as jax_main
    errs = []
    for main in (port_main, jax_main):
        with pytest.raises(SystemExit) as ex:
            main(["--parentswap"])
        assert ex.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0].split(": ", 1)[1] == errs[1].split(": ", 1)[1]
    assert "--parentswap requires --flipmode negshift" in errs[0]
