"""The port's command line (``python -m cnf2freq_tpu_torch``) against the
JAX package's, and the reporters it runs.

* CLI parity: a 12 x 16 PlantImpute file set, float64, on the CPU.  The
  JAX CLI runs with the port's determinism rules patched in
  (``torch_port_util.patch_jax_with_port_rules``, test-side only), the
  port's with ``--device cpu``; both with ``--count 2 --output --dump
  --lineorigin --checkpoint``.  Every number they print agrees to 2e-5
  (the files print 5-6 decimals), and the checkpoint headers' JSON is
  equal.
* Cross-package resume: the port's CLI resumes from the JAX checkpoint to
  ``--count 3`` and the JAX CLI from a copy of the same checkpoint; their
  outputs agree to 2e-5, and each runs iteration 2 only.
* ``line_origin_posterior`` agrees with the JAX function at 1e-12 on a
  cohort with vacant first- and second-branch parents, attop parents and
  a founder focal.
* Map re-estimation: ``recombination_expectations`` agrees with the JAX
  function at 1e-12, a chunk's expectations from a scan's sweeps with
  the JAX package's ``make_jitted_recomb`` at 1e-12 and the rate update
  with the JAX Driver's ``_apply_recomb`` exactly; the port's
  ``Driver(remap_distances=True)`` accumulates once per chunk, updates
  once per chromosome and iteration, and scans the next iteration with
  the re-estimated rates.  (A whole JAX Driver run with remapping costs
  more JAX tracing and compilation than this file's budget allows.)
* No fallback: ``--device cuda`` without a card raises the Driver's error
  and writes nothing; ``--model selfing`` (not ported) is refused, and
  each flag of another input set or ``--trace`` alone is an incomplete
  input set, on which the port returns what the JAX CLI returns, with its
  message.
"""
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_port_util import (OUTPUTS, assert_same_numbers, cohort,
                             jax_batch, run_jax_cli, t, torch_batch)

from cnf2freq_tpu_torch import Driver
from cnf2freq_tpu_torch.cli import main as port_main
from cnf2freq_tpu_torch.io import load_plantimpute
from cnf2freq_tpu_torch.pedigree import from_host
from cnf2freq_tpu_torch.utils.simulate import simulate_plantimpute_files

def header(path):
    with open(path) as f:
        head = f.readline()
    assert head.startswith("# driverstate ")
    return json.loads(head[len("# driverstate "):])


def _args(files, tag, d, count, ckpt):
    mapfile, pedfile, genfile = files
    return ["--mapfile", mapfile, "--pedfile", pedfile, "--genfile",
            genfile, "--count", str(count),
            "--output", os.path.join(d, f"{tag}.out"),
            "--dump", os.path.join(d, f"{tag}.dump"),
            "--lineorigin", os.path.join(d, f"{tag}.lo"),
            "--checkpoint", ckpt]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 12 x 16 PlantImpute file set."""
    return simulate_plantimpute_files(str(tmp_path_factory.mktemp("files")),
                                      n_f2=12, n_markers=16, seed=11)[:3]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, files):
    d = str(tmp_path_factory.mktemp("cli"))
    out = {"dir": d, "files": files}
    for tag, run, extra in (("jax", run_jax_cli, []),
                            ("port", port_main, ["--device", "cpu"])):
        ck = os.path.join(d, f"{tag}.ck")
        assert run(_args(files, tag, d, 2, ck) + extra) == 0
    # both resume from copies of the JAX checkpoint
    for tag in ("jax3", "port3"):
        shutil.copy(os.path.join(d, "jax.ck"), os.path.join(d, f"{tag}.ck"))
    return out


def test_cli_parity(runs):
    d = runs["dir"]
    for ext in OUTPUTS:
        assert_same_numbers(os.path.join(d, f"port.{ext}"),
                            os.path.join(d, f"jax.{ext}"))
    hp, hj = header(os.path.join(d, "port.ck")), header(os.path.join(d,
                                                                     "jax.ck"))
    assert hp == hj and hp["iterations_done"] == 2
    assert_same_numbers(os.path.join(d, "port.ck"), os.path.join(d, "jax.ck"))
    # every F2 unit has a block
    with open(os.path.join(d, "port.out")) as f:
        assert sum(line.startswith("F2_") for line in f) == 12


def test_cross_package_resume(runs, capsys):
    d, files = runs["dir"], runs["files"]
    capsys.readouterr()
    assert port_main(_args(files, "port3", d, 3,
                           os.path.join(d, "port3.ck")) +
                     ["--device", "cpu"]) == 0
    err_port = capsys.readouterr().err
    assert run_jax_cli(_args(files, "jax3", d, 3,
                             os.path.join(d, "jax3.ck"))) == 0
    err_jax = capsys.readouterr().err
    for err in (err_port, err_jax):
        assert "(2 iterations done)" in err
        iters = [ln.split(":")[0] for ln in err.splitlines()
                 if ln.startswith("iter ")]
        assert iters == ["iter 2"]
    for ext in OUTPUTS + ("ck",):
        assert_same_numbers(os.path.join(d, f"port3.{ext}"),
                            os.path.join(d, f"jax3.{ext}"))
    assert header(os.path.join(d, "port3.ck")) == \
        header(os.path.join(d, "jax3.ck"))


def test_cuda_cli_fails_without_card(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ck = tmp_path / "c.ck"
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(_args(files, "c", str(tmp_path), 1, str(ck)) +
                  ["--device", "cuda"])
    assert not [p for p in os.listdir(tmp_path) if not p.startswith(".")]


# the port carries the flip modes native and negshift, --parentswap with
# negshift only (the JAX CLI's rule) and a numeric --markerblock; argparse
# refuses the others, and --model selfing / relskewstates (not ported)
ERRORS = {"--model": "the extended state spaces are not ported yet",
          "--flipmode": "invalid choice: 'toulbar'",
          "--parentswap": "--parentswap requires --flipmode negshift",
          "--markerblock": "invalid int value: 'x'"}
# flags of the other input sets, and --trace: alone, none makes an input
# set
INCOMPLETE = {"--trace", "--samplefile", "--bimfile", "--hapfiles",
              "--famfile", "--bedfile", "--createhapfile", "--merlinmap",
              "--merlinped", "--gigimapfile", "--gigipedfile", "--markerinfo",
              "--ccoeffped", "--ccoeffgen", "--templatevcffile",
              "--outputvcffile"}


@pytest.mark.parametrize("flag", [
    ["--model", "selfing"], ["--flipmode", "toulbar"], ["--parentswap"],
    ["--markerblock", "x"], ["--trace", "t.jsonl"], ["--samplefile", "s"],
    ["--bimfile", "b"], ["--hapfiles", "h"], ["--famfile", "f"],
    ["--bedfile", "b"], ["--createhapfile", "h"], ["--merlinmap", "m"],
    ["--merlinped", "m"], ["--gigimapfile", "g"], ["--gigipedfile", "g"],
    ["--markerinfo", "m"], ["--ccoeffped", "c"], ["--ccoeffgen", "c"],
    ["--templatevcffile", "v"], ["--outputvcffile", "v"]],
    ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_flags_it_does_not_carry(flag, capsys, tmp_path,
                                             monkeypatch):
    """--model selfing (not ported), a flip mode the port does not carry, a
    marker block that is not a number, and --parentswap without the
    negshift flip mode (the JAX CLI's rule) are argparse errors; a flag of
    another input set or --trace alone returns what the JAX CLI returns
    for the same arguments (2), with its message, and writes nothing."""
    monkeypatch.chdir(tmp_path)
    if flag[0] in INCOMPLETE:
        capsys.readouterr()
        rc = port_main(["--device", "cpu"] + flag)
        err = capsys.readouterr().err
        assert rc == run_jax_cli(flag) == 2
        assert err == capsys.readouterr().err
        assert "--hapfiles without --samplefile" in err if \
            flag[0] == "--hapfiles" else "need an input set" in err
        assert not os.listdir(tmp_path)
        return
    with pytest.raises(SystemExit) as ex:
        port_main(["--device", "cpu"] + flag)
    assert ex.value.code == 2
    assert ERRORS.get(flag[0], "unrecognized arguments") in \
        capsys.readouterr().err


# ---------------------------------------------------------------------------
# Reporters
# ---------------------------------------------------------------------------
def _line_origin_cohort():
    """cohort(with_vacant=True) plus a founder focal and units with only
    the first or only the second parent."""
    ped, _, _, cfg, _ = cohort(with_vacant=True)
    f2 = [ped.by_id(n) for n in ped.dous]
    extra = []
    for k, name in enumerate(("half_sire", "half_dam")):
        ind = ped.getind(name)
        ind.pars = (f2[0].pars[0], 0) if k == 0 else (0, f2[1].pars[1])
        ind.gen = 2
        extra.append(ind)
    ped.freeze()
    for k, ind in enumerate(extra):
        ind.markerdata[:] = f2[k].markerdata
        ind.markersure[:] = f2[k].markersure
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    founder = next(i.n for i in ped.inds[1:] if i.founder)
    f1 = [i.n for i in ped.inds[1:]
          if i.pars[0] and ped.by_id(i.pars[0]).founder][:2]
    focals = list(ped.dous) + f1 + [i.n for i in extra] + [founder]
    from cnf2freq_tpu_torch.hmm.family import gather_family
    fb = gather_family(ped, focals, 0, ped.num_markers - 1)
    rng = np.random.default_rng(3)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    return fb, cfg


def test_line_origin_posterior_matches():
    import jax

    from cnf2freq_tpu.config import ModelConfig as JaxConfig
    from cnf2freq_tpu.hmm.emission import build_blocks as jax_blocks
    from cnf2freq_tpu.hmm.probes import line_origin_posterior as jax_lo

    from cnf2freq_tpu_torch.hmm.emission import build_blocks
    from cnf2freq_tpu_torch.hmm.probes import line_origin_posterior
    fb, cfg = _line_origin_cohort()
    ps = [cfg.parent_slot(k) for k in range(2)]
    # what the cohort must cover (probes.py's branches)
    assert (~fb.exists[:, ps[0]]).any() and (~fb.exists[:, ps[1]]).any()
    assert (fb.exists[:, ps[0]] & ~fb.exists[:, ps[1]]).any()
    assert (~fb.exists[:, ps[0]] & fb.exists[:, ps[1]]).any()
    assert (fb.attop[:, ps[0]] & fb.exists[:, ps[0]]).any()
    assert fb.attop[:, 0].any()
    B, _, M, _ = fb.md.shape
    W = np.random.default_rng(4).uniform(0.0, 1.0, (B, M, 8, 64))
    got = line_origin_posterior(t(W), build_blocks(torch_batch(fb), cfg),
                                torch_batch(fb), cfg)
    jcfg = JaxConfig()
    # one program: eager JAX would compile every einsum on its own
    want = np.asarray(jax.jit(lambda w, b: jax_lo(
        w, jax_blocks(b, jcfg, dtype=np.float64), b, jcfg))(
            W, jax_batch(fb)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, rtol=1e-12)
    # the founder focal's third class is empty
    assert (got.numpy()[-1, :, 2] == 0).all()


def test_recombination_expectations_match():
    import jax.numpy as jnp

    from cnf2freq_tpu.config import ModelConfig as JaxConfig
    from cnf2freq_tpu.hmm.forward_backward import FBResult as JaxFB
    from cnf2freq_tpu.hmm.probes import recombination_expectations as jre
    from cnf2freq_tpu.hmm.transition import \
        transition_eigenvalues as jax_eig

    from cnf2freq_tpu_torch.config import ModelConfig
    from cnf2freq_tpu_torch.hmm.forward_backward import FBResult
    from cnf2freq_tpu_torch.hmm.probes import recombination_expectations
    from cnf2freq_tpu_torch.hmm.transition import transition_eigenvalues
    rng = np.random.default_rng(9)
    B, M = 5, 7
    big = [rng.uniform(0.0, 1.0, (B, M, 8, 64)) for _ in range(4)]
    small = [rng.normal(0.0, 3.0, (B, M, 8)) for _ in range(3)]
    r = rng.uniform(0.0, 0.3, (M - 1, 6))
    fw_pre, fw_post, bw, e = big
    parts = dict(fw_pre=fw_pre, fw_post=fw_post, bw=bw, fw_pre_f=small[0],
                 fw_post_f=small[1], bw_f=small[2])
    cfg = ModelConfig()
    got = recombination_expectations(
        FBResult(**{k: t(v) for k, v in parts.items()}), t(e), cfg,
        transition_eigenvalues(cfg, t(r)))
    want = jre(JaxFB(**{k: jnp.asarray(v) for k, v in parts.items()}),
               jnp.asarray(e), JaxConfig(),
               jax_eig(JaxConfig(), jnp.asarray(r)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_recomb_chunk_and_rate_update_match_jax():
    """The two halves of a remap iteration against the JAX Driver's: a
    chunk's expectations from a scan's sweeps (``make_jitted_recomb``)
    and the per-chromosome EM update of ``ped.actrec``."""
    from cnf2freq_tpu.driver import Driver as JaxDriver
    from cnf2freq_tpu.engine import make_jitted_recomb
    from cnf2freq_tpu.utils.simulate import simulate_f2 as jax_simulate

    from cnf2freq_tpu_torch.engine import recomb_expectations
    ped, fb, dists, cfg, params = cohort()
    B, _, M, _ = fb.md.shape
    rng = np.random.default_rng(12)
    sweeps = dict(fw_pre=rng.uniform(0.0, 1.0, (B, M, 8, 64)),
                  bw=rng.uniform(0.0, 1.0, (B, M, 8, 64)),
                  fw_pre_f=rng.normal(0.0, 3.0, (B, M, 8)),
                  bw_f=rng.normal(0.0, 3.0, (B, M, 8)))
    rm = np.tile(rng.uniform(-0.05, -0.005, (M - 1, 1)), (1, 6))
    got = recomb_expectations(torch_batch(fb), t(dists),
                              SimpleNamespace(**{k: t(v) for k, v in
                                                 sweeps.items()}),
                              cfg, params, ratemat=t(rm))
    from cnf2freq_tpu.config import ModelConfig as JaxConfig
    from cnf2freq_tpu.config import RuntimeParams as JaxParams
    run = make_jitted_recomb(JaxConfig(), JaxParams())
    want = np.asarray(run(jax_batch(fb), dists, *sweeps.values(),
                          ratemat=rm))
    assert np.isfinite(want).all() and (want > 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)

    # the EM update of the per-sex interval rates, twice (the second
    # blends into the first's actrec), on two chromosomes
    base = jax_simulate(n_f2=2, n_markers=6, n_chromosomes=2, seed=1)
    dj = JaxDriver(base, dtype=np.float64)
    dp = Driver(from_host(base), dtype=torch.float64, device="cpu")
    for _ in range(2):
        for c in range(base.num_chromosomes):
            lo, hi = base.chromosome_range(c)
            acc = (rng.uniform(0.0, 5.0, (2, hi - lo - 1)),
                   np.array([4, 0 if c else 7]))
            dj._apply_recomb(lo, hi, acc)
            dp._apply_recomb(lo, hi, acc)
    assert (dp.ped.actrec != dp.params.baserec).any()
    np.testing.assert_array_equal(dp.ped.actrec, dj.ped.actrec)


def test_driver_remap_distances(files, monkeypatch):
    """Driver(remap_distances=True): one accumulation per chunk and one
    rate update per chromosome and iteration, and the re-estimated rates
    feed the next iteration's transition."""
    from cnf2freq_tpu_torch.driver import Driver as PortDriver
    from cnf2freq_tpu_torch.hmm import transition
    calls = {"acc": 0, "apply": 0, "rates": [], "updated": []}
    acc, apply, rate_matrix = (PortDriver._accumulate_recomb,
                               PortDriver._apply_recomb,
                               transition.rate_matrix)

    def count(key, fn):
        def wrapped(self, *a, **kw):
            calls[key] += 1
            out = fn(self, *a, **kw)
            if key == "apply":
                calls["updated"].append(self.ped.actrec.copy())
            return out
        return wrapped

    def rates(cfg, params, n, actrec=None, lo=0, dtype=np.float64):
        calls["rates"].append(None if actrec is None else actrec.copy())
        return rate_matrix(cfg, params, n, actrec, lo, dtype)

    monkeypatch.setattr(PortDriver, "_accumulate_recomb",
                        count("acc", acc))
    monkeypatch.setattr(PortDriver, "_apply_recomb", count("apply", apply))
    monkeypatch.setattr("cnf2freq_tpu_torch.driver.rate_matrix", rates)
    d = Driver(load_plantimpute(*files), dtype=torch.float64, device="cpu")
    d.remap_distances = True
    d.preprocess()
    for i in range(2):
        d.iterate(early=(i == 0))
    assert calls["acc"] == 2 and calls["apply"] == 2
    # iteration 1 scanned with the rates iteration 0 re-estimated
    assert calls["rates"][0] is None
    np.testing.assert_array_equal(calls["rates"][1], calls["updated"][0])
    actrec = d.ped.actrec
    assert (actrec != calls["updated"][0]).any()
    lo, hi = d.ped.chromosome_range(0)
    assert np.isfinite(actrec).all()
    assert (actrec[:, lo + 1:hi] != d.params.baserec).any()
    assert (actrec[:, lo + 1:hi] <= -1e-4).all() and \
        (actrec[:, lo + 1:hi] >= -20.0).all()
