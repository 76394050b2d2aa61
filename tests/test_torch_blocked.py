"""The port's marker-blocked scan against the JAX package's, and against
the port's own unblocked path (float64, on the CPU).

* Sweep pieces (seeded numpy inputs, 4 markers x 1024 units, one shift
  chain with a zero emission sum): ``ops.scan.fb_carry_fwd``,
  ``fb_carry_bwd`` and ``fb_scan_v2_block`` against the JAX functions,
  and ``ops.scan.fb_sweeps(lam_pad=, init_fwd=, init_bwd=)`` and
  ``fb_carry`` (the wrappers of kernel #2 with boundary carries and in
  carry-only mode, here on their plain twins) against
  ``fb_sweeps_v2_pallas(interpret=True)`` with the same carries and the
  JAX carry functions: rtol 1e-12.
* One batch chunk, simulate_f2(n_f2=5, n_markers=16, missing_rate=0.2,
  error_rate=0.02, seed=21) with block 4, built as tests/test_blocked.py
  builds it: ``blocked_carries`` (totals and every boundary carry) and
  ``blocked_scan_chunk`` (totals, pair, hb, hc, inf and each block's turn
  weights) against the JAX functions: rtol 1e-10.
* The port's Driver blocked against the port's Driver unblocked, no JAX,
  preprocess and one full iteration, in the JAX tests' terms
  (tests/test_blocked.py): haploweights and pair tables at rtol 1e-8 /
  atol 1e-11, imputed calls equal except at near-ties; with adaptive
  relhaplo off, chunked (batch_size 3 of 7 units), with coherence
  (relhaplo too), with map re-estimation (actrec too), with negshift
  (lastinved too), and on two chromosomes of 10 markers (padded to 12).
* The slice against the JAX Driver: 12 x 16 with marker_block=4, adaptive
  relhaplo off, early plus one full iteration, through
  ``torch_port_util.run_pair`` (the port's rules patched into the JAX
  Driver) at that harness's tolerances.
* Refusals: parent-pair swaps under blocking, resident=True with
  marker_block, parity mode.
* ``python -m cnf2freq_tpu_torch --markerblock 8`` on a 12 x 16 file set
  prints the numbers of the unblocked run, to 2e-5.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (OUTPUTS, assert_same_numbers,
                             check_anchor_departures, check_iterations,
                             run_pair, t)

from cnf2freq_tpu.config import ModelConfig as JaxConfig
from cnf2freq_tpu.config import RuntimeParams as JaxParams
from cnf2freq_tpu.hmm.family import gather_family as jax_gather
from cnf2freq_tpu.hmm.transition import rate_matrix
from cnf2freq_tpu.hmm.transition import \
    transition_eigenvalues as jax_eigenvalues
from cnf2freq_tpu.ops import scan_v2 as v2
from cnf2freq_tpu.utils.simulate import simulate_f2
from cnf2freq_tpu_torch import Driver
from cnf2freq_tpu_torch.cli import main as port_main
from cnf2freq_tpu_torch.config import MINFACTOR, ModelConfig, RuntimeParams
from cnf2freq_tpu_torch.hmm.family import gather_family
from cnf2freq_tpu_torch.ops import scan as ps
from cnf2freq_tpu_torch.utils.simulate import simulate_f2 as port_simulate
from cnf2freq_tpu_torch.utils.simulate import simulate_plantimpute_files

# rtol, and an absolute floor relative to the array's largest magnitude
# (the log-factors pass through zero: f0 + sum log s cancels)
SWEEP_RTOL, SWEEP_FLOOR = 1e-12, 1e-14
CHUNK_RTOL, CHUNK_ATOL = 1e-10, 1e-12
K, R = 4, 1024


@pytest.fixture(scope="module")
def sweep_inputs():
    """e [K, 512, R], lam_pad [K, 64], lam_below [64] and both carries."""
    rng = np.random.default_rng(17)
    e = rng.uniform(0.0, 1.0, (K, 512, R))
    e[1, 64:128, 3] = 0.0        # one dead (unit, shift) chain: MINFACTOR
    lam = np.asarray(jax_eigenvalues(
        JaxConfig(), jnp.asarray(rng.uniform(0.01, 0.3, (K + 1, 6)))))
    return dict(e=e, lam_pad=lam[:K], lam_below=lam[K],
                p0=rng.uniform(0.0, 1.0, (512, R)),
                f0=rng.normal(0.0, 3.0, (8, R)),
                bT=rng.uniform(0.0, 1.0, (512, R)),
                bfT=rng.normal(0.0, 3.0, (8, R)))


def _close(got, want, rtol=SWEEP_RTOL, atol=None, msg=""):
    want = np.asarray(want)
    if atol is None:
        atol = SWEEP_FLOOR * np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("piece", ["carry_fwd", "carry_bwd", "block",
                                   "wrapper_sweeps", "wrapper_carries"])
def test_sweep_pieces_match_jax(sweep_inputs, piece):
    x = sweep_inputs
    jcfg, cfg = JaxConfig(), ModelConfig()
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: t(v) for k, v in x.items()}
    if piece == "carry_fwd":
        pairs = [(ps.fb_carry_fwd(T["e"], T["lam_pad"], T["p0"], T["f0"],
                                  cfg),
                  v2.fb_carry_fwd(J["e"], J["lam_pad"], J["p0"], J["f0"],
                                  jcfg))]
    elif piece == "carry_bwd":
        pairs = [(ps.fb_carry_bwd(T["e"], T["lam_pad"], T["lam_below"],
                                  T["bT"], T["bfT"], cfg),
                  v2.fb_carry_bwd(J["e"], J["lam_pad"], J["lam_below"],
                                  J["bT"], J["bfT"], jcfg))]
    elif piece == "block":
        pairs = [(ps.fb_scan_v2_block(T["e"], T["lam_pad"], T["p0"], T["f0"],
                                      T["bT"], T["bfT"], cfg),
                  v2.fb_scan_v2_block(J["e"], J["lam_pad"], J["p0"], J["f0"],
                                      J["bT"], J["bfT"], jcfg))]
    elif piece == "wrapper_sweeps":
        pairs = [(ps.fb_sweeps(T["e"], None, cfg, None, lam_pad=T["lam_pad"],
                               init_fwd=(T["p0"], T["f0"]),
                               init_bwd=(T["bT"], T["bfT"])),
                  v2.fb_sweeps_v2_pallas(
                      J["e"], None, jcfg, JaxParams(), interpret=True,
                      lam_pad=J["lam_pad"], init_fwd=(J["p0"], J["f0"]),
                      init_bwd=(J["bT"], J["bfT"])))]
    else:
        pairs = [(ps.fb_carry(T["e"], T["lam_pad"], cfg,
                              init=(T["p0"], T["f0"])),
                  v2.fb_carry_fwd(J["e"], J["lam_pad"], J["p0"], J["f0"],
                                  jcfg)),
                 (ps.fb_carry(T["e"], T["lam_pad"], cfg,
                              init=(T["bT"], T["bfT"]), backward=True,
                              lam_below=T["lam_below"]),
                  v2.fb_carry_bwd(J["e"], J["lam_pad"], J["lam_below"],
                                  J["bT"], J["bfT"], jcfg))]
    for got, want in pairs:
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.isfinite(np.asarray(w)).all()
            _close(g.numpy(), w, msg=f"{piece} output {i}")
    # the dead chain renormalised to zero with MINFACTOR
    if piece == "block":
        assert pairs[0][0].fw_post_f[1, 1, 3].item() == MINFACTOR


# ---------------------------------------------------------------------------
# One batch chunk
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chunk_runs():
    ped = simulate_f2(n_f2=5, n_markers=16, missing_rate=0.2,
                      error_rate=0.02, seed=21)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    jcfg, jparams = JaxConfig(), JaxParams()
    ids = [ind.n for ind in ped.inds[1:]]
    NI = len(ids)
    lut = np.full(max(ids) + 1, NI, dtype=np.int32)
    for i, n in enumerate(ids):
        lut[n] = i
    M = ped.num_markers
    dists = np.diff(ped.markerposes)
    rm = rate_matrix(jcfg, jparams, M - 1)

    fb = jax_gather(ped, ped.dous, 0, M - 1)
    pieces = v2.make_blocked_pieces(jcfg, jparams, jnp.float64, NI,
                                    interpret=True)
    jax_carries = v2.blocked_carries(fb, dists, rm, jcfg, 4, pieces)
    jax_turns = {}
    jax_chunk = v2.blocked_scan_chunk(
        fb, dists, rm, jnp.asarray(lut), jcfg, jparams, block=4,
        pieces=pieces,
        turn_consumer=lambda off, w, hb, hc: jax_turns.__setitem__(
            off, np.asarray(w)))

    fbt = gather_family(ped, list(ped.dous), 0, M - 1).to("cpu",
                                                          torch.float64)
    cfg, params = ModelConfig(), RuntimeParams()
    port_carries = ps.blocked_carries(fbt, t(dists), t(rm), cfg, params, 4)
    port_turns = {}
    port_chunk = ps.blocked_scan_chunk(
        fbt, t(dists), t(rm), t(lut, torch.int64), cfg, params, 4, NI,
        turn_consumer=lambda off, w: port_turns.__setitem__(off, w.numpy()))
    return dict(B=len(ped.dous), jax=(jax_carries, jax_chunk, jax_turns),
                port=(port_carries, port_chunk, port_turns))


def test_blocked_carries_match_jax(chunk_runs):
    B = chunk_runs["B"]
    (total, _, _, fbound, bbound), _, _ = chunk_runs["jax"]
    bc, _, _ = chunk_runs["port"]
    assert bc.st.R == 32 and len(bc.fbound) == len(bc.bbound) == 4
    _close(bc.total_r[:B].numpy(), total, CHUNK_RTOL, CHUNK_ATOL, "total")
    for name, got, want in (("fbound", bc.fbound, fbound),
                            ("bbound", bc.bbound, bbound)):
        for i, (g, w) in enumerate(zip(got, want)):
            for j in range(2):
                _close(g[j][:, :B].numpy(), np.asarray(w[j])[:, :B],
                       CHUNK_RTOL, CHUNK_ATOL, f"{name}[{i}][{j}]")


def test_blocked_scan_chunk_matches_jax(chunk_runs):
    _, want, jturns = chunk_runs["jax"]
    _, got, pturns = chunk_runs["port"]
    for name, g, w in zip(("total", "pair", "hb", "hc", "inf"), got, want):
        _close(g.numpy(), w, CHUNK_RTOL, CHUNK_ATOL, name)
    assert sorted(pturns) == sorted(jturns) == [0, 4, 8, 12]
    for off in jturns:
        w, g = jturns[off], pturns[off]
        finite = w > -1e14
        np.testing.assert_array_equal(finite, g > -1e14)
        _close(g[finite], w[finite], CHUNK_RTOL, CHUNK_ATOL, f"turn {off}")


# ---------------------------------------------------------------------------
# The Driver
# ---------------------------------------------------------------------------
BLOCKED_CASES = {
    # name: (simulate_f2 arguments, driver attributes)
    "adaptive_off": (dict(n_f2=5, seed=21), dict(adaptive_relhaplo=False)),
    "chunked": (dict(n_f2=7, seed=23),
                dict(adaptive_relhaplo=False, batch_size=3)),
    "coherence": (dict(n_f2=5, seed=29), {}),
    "remap": (dict(n_f2=5, seed=31),
              dict(adaptive_relhaplo=False, remap_distances=True)),
    "negshift": (dict(n_f2=8, seed=31),
                 dict(adaptive_relhaplo=False, flip_mode="negshift")),
    "two_chromosomes": (dict(n_f2=5, seed=37, n_markers=10,
                             n_chromosomes=2), {}),
}


@pytest.mark.parametrize("case", list(BLOCKED_CASES))
def test_driver_blocked_matches_unblocked(case):
    sim, attrs = BLOCKED_CASES[case]
    sim = dict(dict(n_markers=16, missing_rate=0.2, error_rate=0.02), **sim)
    peds = [port_simulate(**sim) for _ in range(2)]
    drvs = [Driver(p, dtype=torch.float64, device="cpu") for p in peds]
    drvs[0].marker_block = 4
    for d in drvs:
        for k, v in attrs.items():
            setattr(d, k, v)
        d.preprocess()
        d.iterate(early=False)
    assert not drvs[0]._use_resident()
    for a, b in zip(peds[0].inds[1:], peds[1].inds[1:]):
        np.testing.assert_allclose(a.haploweight, b.haploweight, rtol=1e-8,
                                   atol=1e-11, err_msg=a.name)
        if attrs.get("adaptive_relhaplo", True):
            np.testing.assert_allclose(a.relhaplo, b.relhaplo, rtol=1e-8,
                                       atol=1e-11, err_msg=a.name)
        if case == "negshift":
            np.testing.assert_array_equal(a.lastinved, b.lastinved)
        # imputed calls agree except where the posterior is a near-tie
        mism = a.markerdata != b.markerdata
        if mism.any():
            sure = np.minimum(a.markersure[mism], b.markersure[mism])
            assert (sure > 0.4).all(), (a.name, a.markerdata[mism])
    for n in peds[0].dous:
        np.testing.assert_allclose(drvs[0].pair_tables[n],
                                   drvs[1].pair_tables[n], rtol=1e-8,
                                   atol=1e-11)
    if case == "remap":
        assert (peds[0].actrec != RuntimeParams().baserec).any()
        np.testing.assert_allclose(peds[0].actrec, peds[1].actrec,
                                   rtol=1e-8, atol=1e-11)
    if attrs.get("adaptive_relhaplo", True):
        rh = np.stack([i.relhaplo for i in peds[0].inds[1:]])
        assert (rh != 0.5).any()


def test_blocked_slice_matches_jax_driver():
    runs = run_pair(simulate_f2(n_f2=12, n_markers=16), adaptive=False,
                    iters=2, marker_block=4)
    check_iterations(runs, ("haploweight", "markersure"))
    check_anchor_departures(runs["seen"]["anchors"])
    assert runs["seen"]["winners"]  # the flip solve ran
    assert sum(runs["seen"]["winners"]) <= 1


@pytest.mark.parametrize("refusal", ["parent_swap", "resident", "parity"])
def test_blocked_refusals(refusal):
    d = Driver(port_simulate(n_f2=3, n_markers=8, seed=2),
               dtype=torch.float64, device="cpu")
    d.marker_block = 4
    if refusal == "resident":
        d.resident = True
        with pytest.raises(ValueError, match="marker-blocked"):
            d.iterate(early=True)
    elif refusal == "parity":
        d.parity = True
        with pytest.raises(NotImplementedError, match="parity"):
            d.iterate(early=True)
    else:
        d.flip_mode, d.parent_swap = "negshift", True
        d.preprocess()
        d.iterate(early=True)       # the early pass makes no flips
        with pytest.raises(NotImplementedError, match="unblocked-only"):
            d.iterate()


def test_cli_markerblock(tmp_path):
    """--markerblock 8 blocks the 16-marker chromosome and prints the
    numbers of the unblocked run; --markerblock 0 is off, as in the JAX
    CLI."""
    files = simulate_plantimpute_files(str(tmp_path), n_f2=12, n_markers=16,
                                       seed=11)[:3]
    blocked = []
    real = Driver._chromosome_blocked

    def counted(self, *a, **kw):
        blocked.append(self.marker_block)
        return real(self, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Driver, "_chromosome_blocked", counted)
        for tag, extra in (("plain", ["--markerblock", "0"]),
                           ("blocked", ["--markerblock", "8"])):
            argv = ["--mapfile", files[0], "--pedfile", files[1],
                    "--genfile", files[2], "--device", "cpu", "--count", "2"]
            for ext, flag in zip(OUTPUTS, ("--output", "--lineorigin",
                                           "--dump")):
                argv += [flag, os.path.join(tmp_path, f"{tag}.{ext}")]
            assert port_main(argv + extra) == 0
    assert blocked == [8, 8]
    for ext in OUTPUTS:
        assert_same_numbers(os.path.join(tmp_path, f"blocked.{ext}"),
                            os.path.join(tmp_path, f"plain.{ext}"))
