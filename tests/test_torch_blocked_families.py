"""The port's marker-blocked scans of the ng2, SELFING and RELSKEWSTATES
families (``blocked_families.py``) against the JAX package's and against
the port's own whole-chromosome scans, float64 on the CPU.

* Sweep twins (seeded numpy inputs; a random row-stochastic coupling on
  the extended spaces, so that the backward step's orientation shows):
  ``ops.fb.fb_small_block`` / ``fb_ext_block`` (the plain twins of the
  seeded entries of csrc/fb_small.cu and csrc/fb_ext.cu) with the
  whole-chromosome seeds equal the whole sweeps exactly; the carry-only
  twins ``fb_small_carry`` / ``fb_ext_carry`` chained over the blocks
  equal the whole sweep's boundary columns exactly, and the seeded sweeps
  from those carries its slices.
* One batch chunk, 18 markers in blocks of 4 (padded to 20), on the
  cohorts of tests/test_blocked.py (ng2 with the F1 parents typed;
  RELSKEWSTATES with relhaplo drawn from U(0.2, 0.9)), haploweights and
  error rates randomised: the port's ``blocked_family_chunk`` against the
  JAX package's (``make_blocked_family_pieces`` + ``blocked_family_chunk``,
  jitted: eagerly the three families took 4 minutes on one CPU core, jitted
  30 s), per block pair, hb, hc, inf and turn weights on the real markers
  at rtol 1e-9 / atol 1e-12, with one probe-dedup variant (the SELFING
  Driver's 16 took the JAX package 219 s to compile, the RELSKEWSTATES
  Driver's 4 doubled its 15 s; the variants' statistics are held to the
  JAX package in tests/test_torch_selfing.py and
  tests/test_torch_relskewstates.py, and the Driver cases below run
  them blocked against whole).  The totals equal the port's
  whole-chromosome scan's; the JAX module's differ by the padded markers'
  emission (n_pad log 0.5 a unit under RELSKEWSTATES), which the port
  sets to 1.
* The Driver, 18 markers, block 4, preprocess and two iterations (the
  first early): the port's blocked Driver against its whole Driver for
  each family (haploweights and pair tables at rtol 1e-8 / atol 1e-11,
  calls equal but at near ties, the same log-likelihood), and the ng2
  run against the JAX Driver's blocked run (``run_pair``, the port's
  rules patched into the JAX side); RELSKEWSTATES with adaptive relhaplo
  on: the notice once, relhaplo as loaded.
* Refusals before any work: blocked nohaplo, and on a blocked family
  chromosome negshift flips and parent swaps (a full iteration) and map
  re-estimation.
* ``--markerblock 4`` through the port's CLI for each family (10
  markers, padded to 12) writes the bytes of the port Driver's blocked
  run with the same settings.
"""
import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import check_iterations, run_pair

from cnf2freq_tpu import blocked_families as JB
from cnf2freq_tpu.config import ModelConfig as JaxConfig
from cnf2freq_tpu.config import RuntimeParams as JaxParams
from cnf2freq_tpu.hmm.family import gather_family as jax_gather
from cnf2freq_tpu.hmm.transition import rate_matrix
from cnf2freq_tpu.ops.scan_v2 import blocked_slice as jax_blocked_slice
from cnf2freq_tpu.parallel.mesh import pad_markers as jax_pad
from cnf2freq_tpu.utils.simulate import simulate_f2, simulate_selfed
from cnf2freq_tpu_torch import Driver, copy_pedigree
from cnf2freq_tpu_torch import blocked_families as PB
from cnf2freq_tpu_torch import config as pconfig
from cnf2freq_tpu_torch.cli import main as port_main
from cnf2freq_tpu_torch.cli import model_config
from cnf2freq_tpu_torch.hmm.family import FamilyBatch
from cnf2freq_tpu_torch.io import load_plantimpute
from cnf2freq_tpu_torch.io.outputs import (write_genotype_table,
                                           write_haplotype_dump)
from cnf2freq_tpu_torch.ops import fb as pfb
from cnf2freq_tpu_torch.parallel.mesh import pad_markers
from cnf2freq_tpu_torch.pedigree import from_host
from cnf2freq_tpu_torch.utils.simulate import (
    simulate_plantimpute_files, simulate_plantimpute_selfed_files)

FAMILIES = ("ng2", "selfing", "relskewstates")
M, BLOCK = 18, 4
CHUNK_RTOL, CHUNK_ATOL = 1e-9, 1e-12
DRIVER_RTOL, DRIVER_ATOL = 1e-8, 1e-11
# the chunk test's probe-dedup variants (see the module docstring)
CHUNK_VARIANTS = {"ng2": 1, "selfing": 1, "relskewstates": 1}


def jax_ped(model, n_markers=M, random_relhaplo=False):
    """tests/test_blocked.py's cohort of a family (JAX Pedigree): ng2 with
    the F1 parents typed from the simulated truth (untyped, every ng2
    unit is a founder with a flat emission)."""
    if model == "selfing":
        return simulate_selfed(n_lines=5, n_markers=n_markers, generations=4,
                               marker_spacing_cm=2.0, seed=11)
    ped = simulate_f2(n_f2=5, n_markers=n_markers, missing_rate=0.2,
                      error_rate=0.02, seed=21 if model == "ng2" else 25)
    if model == "ng2":
        ped.config = JaxConfig(numgen=2)
        for ind in ped.inds[1:]:
            if ind.empty and ind.n in ped.truths:
                ind.markerdata[:] = ped.truths[ind.n]
                ind.markersure[:] = 0.02
                ind.empty = False
    else:
        ped.config = JaxConfig(relskewstates=True)
        if random_relhaplo:
            rng = np.random.default_rng(5)
            for ind in ped.inds[1:]:
                if ind.relhaplo is not None:
                    ind.relhaplo[:] = rng.uniform(0.2, 0.9,
                                                  ind.relhaplo.shape)
    return ped


# ---------------------------------------------------------------------------
# The sweep twins
# ---------------------------------------------------------------------------
def sweep_inputs(model, Mw=12):
    """Random whole-chromosome sweep inputs of a family: (e, lam[, C,
    prior]) as CPU float64 tensors, with zeroed emission entries."""
    rng = np.random.default_rng(31)
    if model == "ng2":
        shape, S = (6, Mw, 2, 4), 4
    else:
        shape, S = (3, Mw, 3 if model == "selfing" else 2, 8, 64), 64
    e = rng.uniform(0.0, 1.0, shape)
    e[rng.random(shape) < 0.2] = 0.0
    bits = (np.arange(S)[:, None] >> np.arange(S.bit_length() - 1)) & 1
    r = rng.uniform(0.0, 0.3, (Mw - 1, S.bit_length() - 1))
    lam = np.where(bits[None] == 1, 1 - 2 * r[:, None, :], 1.0).prod(-1)
    out = [torch.as_tensor(e), torch.as_tensor(lam)]
    if model != "ng2":
        B, V = shape[0], shape[2]
        C = rng.uniform(0.05, 1.0, (B, Mw - 1, V, V))
        C /= C.sum(-1, keepdims=True)
        prior = rng.uniform(0.1, 1.0, (B, V)) / (64 * V)
        out += [torch.as_tensor(C), torch.as_tensor(prior)]
    return out


def _equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{what}: output {i}"


@pytest.mark.parametrize("piece", ["seeded", "chained"])
@pytest.mark.parametrize("model", FAMILIES)
def test_sweep_twins_match_whole(model, piece):
    x = sweep_inputs(model)
    e, lam = x[0], x[1]
    Mw = e.shape[1]
    lam_pad = pfb.pad_lam(lam, e.dtype, e.shape[-1])
    if model == "ng2":
        whole = pfb.fb_sweeps_reference(e, lam, pfb.XLA_CLIP)
        C_pad, seed = None, pfb.seed_carry(e, 0.25)

        def block(e_b, sl, fwd, bwd):
            return pfb.fb_small_block(e_b, lam_pad[sl], fwd, bwd)

        def carry(e_b, sl, c, below=None):
            if below is None:
                return pfb.fb_small_carry(e_b, lam_pad[sl], c)
            return pfb.fb_small_carry(e_b, lam_pad[sl], c, backward=True,
                                      lam_below=lam_pad[below])
    else:
        C, prior = x[2], x[3]
        whole = pfb.fb_ext_reference(e, lam, C, prior)
        C_pad = pfb.pad_coupling(C, e.dtype)
        seed = pfb.ext_prior_seed(e, prior)

        def block(e_b, sl, fwd, bwd):
            return pfb.fb_ext_block(e_b, lam_pad[sl], C_pad[:, sl], fwd, bwd)

        def carry(e_b, sl, c, below=None):
            if below is None:
                return pfb.fb_ext_carry(e_b, lam_pad[sl], C_pad[:, sl], c)
            return pfb.fb_ext_carry(e_b, lam_pad[sl], C_pad[:, sl], c,
                                    backward=True, lam_below=lam_pad[below],
                                    C_below=C_pad[:, below])
    fw_pre, _, bw, fw_pre_f, _, bw_f = whole
    if piece == "seeded":
        _equal(block(e, slice(0, Mw), seed, None), whole, "whole seeds")
        return
    nblk = Mw // BLOCK
    sls = [slice(i * BLOCK, (i + 1) * BLOCK) for i in range(nblk)]
    fbound, c = [], seed
    for i, sl in enumerate(sls):
        fbound.append(c)
        c = carry(e[:, sl], sl, c)
        if i + 1 < nblk:
            _equal(c, (fw_pre[:, sl.stop], fw_pre_f[:, sl.stop]),
                   f"forward carry {i}")
    bbound = [None] * nblk
    c = (torch.ones_like(seed[0]), torch.zeros_like(seed[1]))
    for i in range(nblk - 1, -1, -1):
        bbound[i] = c
        _equal(c, (bw[:, sls[i].stop - 1], bw_f[:, sls[i].stop - 1]),
               f"backward carry {i}")
        if i:
            c = carry(e[:, sls[i]], sls[i], c, below=sls[i].start - 1)
    for i, sl in enumerate(sls):
        _equal(block(e[:, sl], sl, fbound[i], bbound[i]),
               [w[:, sl] for w in whole], f"block {i}")


# ---------------------------------------------------------------------------
# One batch chunk against the JAX package's
# ---------------------------------------------------------------------------
def _lut(ped):
    ids = [ind.n for ind in ped.inds[1:]]
    lut = np.full(max(ids) + 1, len(ids), dtype=np.int32)
    for i, n in enumerate(ids):
        lut[n] = i
    return lut, len(ids)


@pytest.fixture(scope="module", params=FAMILIES)
def chunk_runs(request):
    model = request.param
    ped = jax_ped(model, random_relhaplo=True)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    cfg, nv = ped.config, CHUNK_VARIANTS[model]
    lut, NI = _lut(ped)
    Mp = -(-M // BLOCK) * BLOCK
    dists = np.pad(np.diff(ped.markerposes), (0, Mp - M))
    rm = np.pad(rate_matrix(cfg, JaxParams(), M - 1), ((0, Mp - M), (0, 0)))
    fbj = jax_gather(ped, list(ped.dous), 0, M - 1, n_variants=nv)
    rng = np.random.default_rng(4)
    fbj.hw = rng.uniform(0.05, 0.95, fbj.hw.shape)
    fbj.ms = np.where(fbj.md > 0, rng.uniform(0.0, 0.3, fbj.ms.shape),
                      fbj.ms)
    fbp = FamilyBatch(**{f.name: getattr(fbj, f.name)
                         for f in dataclasses.fields(FamilyBatch)})
    fbj = jax_pad(fbj, Mp)

    pieces = JB.make_blocked_family_pieces(cfg, JaxParams(),
                                           np.dtype("float64"), NI,
                                           n_variants=nv)
    jax_out = [tuple(np.asarray(a) for a in o[1:]) for o in
               JB.blocked_family_chunk(fbj, dists, rm, cfg, JaxParams(),
                                       BLOCK, jnp.asarray(lut), pieces)]
    # the JAX totals, from its own pieces as its generator makes them
    p, f = pieces["init_fwd"](jax_blocked_slice(fbj, 0, BLOCK).map(
        jnp.asarray))
    lam_pad, C_pad = pieces["prep"](
        jnp.asarray(dists), jnp.asarray(rm),
        jnp.asarray(fbj.selfgen) if fbj.selfgen is not None else
        jnp.zeros((fbj.md.shape[0],), dtype=jnp.int32),
        jnp.asarray(fbj.relh) if fbj.relh is not None else
        jnp.full((fbj.md.shape[0], Mp), 0.5))
    for i in range(Mp // BLOCK):
        sl = slice(i * BLOCK, (i + 1) * BLOCK)
        p, f = pieces["carry_f"](
            jax_blocked_slice(fbj, i, BLOCK).map(jnp.asarray), lam_pad[sl],
            None if C_pad is None else C_pad[:, sl], p, f)
    jax_total = np.asarray(pieces["total"](f, jnp.asarray(fbj.shiftignore)))

    pcfg, pparams = from_host(ped).config, pconfig.RuntimeParams()
    fbt = fbp.to("cpu", torch.float64)
    fc = PB.family_carries(pad_markers(fbt, Mp), torch.as_tensor(dists),
                           torch.as_tensor(rm), pcfg, pparams, BLOCK, M)
    port_out = [o[1:] for o in PB.blocked_family_chunk(
        pad_markers(fbt, Mp), None, None, torch.as_tensor(lut).long(), pcfg,
        pparams, BLOCK, NI, nv, carries=fc)]
    # the port's whole-chromosome scan of the same batch
    d = torch.as_tensor(np.diff(ped.markerposes))
    if model == "ng2":
        from cnf2freq_tpu_torch.engine_ng2 import chromosome_scan_ng2
        whole = chromosome_scan_ng2(fbt, d, pcfg, pparams).total
    else:
        from cnf2freq_tpu_torch import engine_ext
        whole = engine_ext.chromosome_scan_ext(fbt, d, pcfg, pparams,
                                               n_variants=nv).total
    # the last block's emission as the engines build it (all markers real)
    _, e_pad = PB.block_emission(PB.blocked_slice(
        pad_markers(fbt, Mp), Mp // BLOCK - 1, BLOCK), pcfg, BLOCK)
    return dict(model=model, jax=jax_out, port=port_out, fc=fc,
                jax_total=jax_total, whole=whole, e_pad=e_pad[:, M % BLOCK:],
                n_pad=Mp - M)


def test_chunk_matches_jax(chunk_runs):
    x = chunk_runs
    assert len(x["port"]) == len(x["jax"]) == -(-M // BLOCK)
    for i, (got, want) in enumerate(zip(x["port"], x["jax"])):
        span = min(BLOCK, M - i * BLOCK)
        for name, g, w in zip(("pair", "hb", "hc", "inf", "turn"), got,
                              want):
            g, w = g.numpy()[:, :span], w[:, :span]
            if name == "turn":
                finite = w > -1e14
                np.testing.assert_array_equal(finite, g > -1e14)
                g, w = g[finite], w[finite]
            np.testing.assert_allclose(g, w, rtol=CHUNK_RTOL,
                                       atol=CHUNK_ATOL,
                                       err_msg=f"{x['model']} block {i} "
                                       f"{name}")


def test_chunk_totals(chunk_runs):
    """The port's totals are its whole scan's; the JAX module's take the
    padded markers' state-constant emission c, n_pad log c a unit."""
    x = chunk_runs
    total = x["fc"].total.numpy()
    np.testing.assert_allclose(total, x["whole"].numpy(), rtol=1e-12,
                               atol=1e-12)
    e_pad = x["e_pad"].reshape(x["e_pad"].shape[0], -1).numpy()
    c = e_pad[:, :1]
    assert (e_pad == c).all()        # state-constant
    if x["model"] == "relskewstates":
        assert (c == 0.5).all()
    np.testing.assert_allclose(total + x["n_pad"] * np.log(c[:, 0]),
                               x["jax_total"], rtol=CHUNK_RTOL,
                               atol=CHUNK_ATOL)


# ---------------------------------------------------------------------------
# The Driver
# ---------------------------------------------------------------------------
def _drive(ped, iters=2, **attrs):
    """A CPU float64 port Driver on ``ped`` with ``attrs``: preprocess and
    ``iters`` iterations (the first early); returns (driver, records)."""
    d = Driver(ped, dtype=torch.float64, device="cpu")
    for k, v in attrs.items():
        setattr(d, k, v)
    d.preprocess()
    return d, [d.iterate(early=(i == 0)) for i in range(iters)]


@pytest.mark.parametrize("model", FAMILIES)
def test_driver_blocked_matches_whole(model, monkeypatch):
    base = jax_ped(model)
    calls = []
    real = Driver._chromosome_blocked_family
    monkeypatch.setattr(Driver, "_chromosome_blocked_family",
                        lambda self, *a: calls.append(1) or real(self, *a))
    monkeypatch.setattr(Driver, "_chromosome_blocked", None)
    runs = [_drive(from_host(copy_pedigree(base)), adaptive_relhaplo=False,
                   marker_block=block) for block in (BLOCK, None)]
    assert len(calls) == 2                    # both iterations ran blocked
    (db, ib), (dw, iw) = runs
    assert not db._use_resident()
    for a, b in zip(ib, iw):
        assert a["hitnnn"] == b["hitnnn"] and a["inverted"] == b["inverted"]
        assert a["loglik"] == pytest.approx(b["loglik"], rel=1e-12)
    assert iw[1]["loglik"] < 0
    for a, b in zip(db.ped.inds[1:], dw.ped.inds[1:]):
        np.testing.assert_allclose(a.haploweight, b.haploweight,
                                   rtol=DRIVER_RTOL, atol=DRIVER_ATOL,
                                   err_msg=a.name)
        mism = a.markerdata != b.markerdata
        if mism.any():
            sure = np.minimum(a.markersure[mism], b.markersure[mism])
            assert (sure > 0.4).all(), (a.name, a.markerdata[mism])
    tabs = [db.pair_tables, dw.pair_tables]
    assert tabs[0].keys() == tabs[1].keys()
    for n in tabs[1]:
        np.testing.assert_allclose(tabs[0][n], tabs[1][n], rtol=DRIVER_RTOL,
                                   atol=DRIVER_ATOL)


def test_driver_ng2_matches_jax_blocked():
    """The ng2 blocked slice against the JAX Driver's blocked run."""
    runs = run_pair(jax_ped("ng2"), adaptive=False, iters=2,
                    marker_block=BLOCK)
    check_iterations(runs, ("haploweight", "markersure"))
    assert sum(runs["seen"]["winners"]) <= 1


def test_blocked_relhaplo_notice(capsys):
    """RELSKEWSTATES with adaptive relhaplo on: a blocked chromosome
    computes no coherence, as in the JAX Driver: the notice once, and
    relhaplo keeps its loaded values."""
    ped = from_host(jax_ped("relskewstates", random_relhaplo=True))
    rh0 = np.stack([i.relhaplo for i in ped.inds[1:]]).copy()
    d, recs = _drive(ped, marker_block=BLOCK)
    assert d.adaptive_relhaplo
    err = capsys.readouterr().err
    assert err.count("adaptive-relhaplo coherence is a whole-chromosome "
                     "feature") == 1
    np.testing.assert_array_equal(
        np.stack([i.relhaplo for i in ped.inds[1:]]), rh0)
    assert all(math.isfinite(r["loglik"]) for r in recs)


@pytest.mark.parametrize("refusal", ["nohaplo", "negshift", "parent_swap",
                                     "remap"])
def test_blocked_family_refusals(refusal):
    """What the families' blocked scan cannot run is refused before any
    work, as in the JAX Driver; negshift and parent swaps only in a full
    iteration (the early one makes no flips)."""
    model = {"nohaplo": "ng2", "remap": "relskewstates"}.get(refusal,
                                                             "selfing")
    ped = from_host(jax_ped(model))
    if refusal == "nohaplo":
        ped.config = pconfig.F2_NOHAPLO
    d = Driver(ped, dtype=torch.float64, device="cpu")
    d.marker_block = BLOCK
    d.preprocess()
    if refusal == "negshift":
        d.flip_mode = "negshift"
    elif refusal == "parent_swap":
        d.parent_swap = True
    elif refusal == "remap":
        d.remap_distances = True
    if refusal in ("negshift", "parent_swap"):
        d.iterate(early=True)
    before = d.state.iter
    hw = [i.haploweight.copy() for i in ped.inds[1:]]
    match = {"nohaplo": "deep-walk", "negshift": "standard space only",
             "parent_swap": "unblocked-only",
             "remap": "standard-space only"}[refusal]
    with pytest.raises(NotImplementedError, match=match):
        d.iterate()
    assert d.state.iter == before
    assert all(np.array_equal(a, i.haploweight)
               for a, i in zip(hw, ped.inds[1:]))


@pytest.mark.parametrize("model", FAMILIES)
def test_cli_markerblock(model, tmp_path):
    """``--markerblock 4 --model m`` writes the genotype table and the
    dumps of the port Driver's blocked run with the same settings."""
    d = str(tmp_path)
    if model == "selfing":
        files = simulate_plantimpute_selfed_files(d, n_lines=5, n_markers=10,
                                                  generations=4, seed=2)[:3]
    else:
        files = simulate_plantimpute_files(d, n_f2=5, n_markers=10,
                                           seed=11)[:3]
    out = {k: os.path.join(d, f"cli.{k}") for k in ("out", "dump")}
    assert port_main(["--mapfile", files[0], "--pedfile", files[1],
                      "--genfile", files[2], "--model", model, "--device",
                      "cpu", "--count", "2", "--markerblock", str(BLOCK),
                      "--output", out["out"], "--dump", out["dump"]]) == 0
    ped = load_plantimpute(*files, config=model_config(model))
    drv = Driver(ped, dtype=torch.float64, device="cpu")
    drv.marker_block = BLOCK
    drv.preprocess()
    with open(os.path.join(d, "drv.dump"), "w") as f:
        for i in range(2):
            drv.iterate(early=(i == 0))
            write_haplotype_dump(ped, f)
    with open(os.path.join(d, "drv.out"), "w") as f:
        write_genotype_table(ped, drv.pair_tables, f)
    for k in ("out", "dump"):
        with open(out[k]) as a, open(os.path.join(d, f"drv.{k}")) as b:
            assert a.read() == b.read(), k
