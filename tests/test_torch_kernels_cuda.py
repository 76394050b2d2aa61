"""The CUDA kernels of cnf2freq_tpu_torch/csrc against their plain PyTorch
versions, on the card (marker ``cuda``; skipped without a CUDA device).

``test_emission_edge_branches`` and ``test_stats_edge_branches`` edit the
family batch so that every branch of the block math that the emission
and statistics kernels' tables replace occurs;
``test_fb_sweep_edges`` and ``test_turn_edges`` hold the sweep and turn
kernels at their edges (one or two markers, an R not a multiple of 64,
zero emission blocks; a single allowed shift, D <= 0).
``test_fb_sweep_blocked`` holds the sweep kernel's entries of the
marker-blocked scan (seeded boundary carries; carry-only, both
directions) against their plain twins, and the blocked chunk scan on the
card against the same scan on the CPU.  ``test_fb_ext_matches_plain``
holds the extended sweeps (V = 2 and 3, a non-symmetric coupling) at
their edges (one or two markers, a zeroed emission row).
``test_fb_small_carries_match_plain`` and
``test_fb_ext_carries_match_plain`` hold the two entries of each family
sweep kernel that the families' marker-blocked scan runs (seeded
boundary carries; carry-only, both directions) against their plain
twins.  The 4-state sweeps and the extended carry-only entry stage
their inputs a tile of markers ahead and run several rows a block or a
warp, so their cases include a marker count that is no multiple of a
tile, zeroed emission rows on tile boundaries, fewer rows than a block
or a warp takes, and float64 carries below the XLA scan's 1e-300 clip.
``test_capped_matches_plain`` and ``test_relskew_matches_plain`` hold the
update stage's kernels (csrc/capped.cu's two entries, csrc/relskew.cu)
against their plain versions on the lanes and rows of
tests/torch_update_util.py, edge lanes included (float64 and float32,
M in {1, 2, 11}, scalefactor 0.013 and 0); the kernels take the plain
versions' roundings operation for operation: csrc/capped.cu's values and
hits must be the plain version's bit for bit, and csrc/relskew.cu's
ratios.  ``test_capped_divergent_lanes`` puts lanes that stop at
very different steps (all 51, or none) side by side in one warp, at lane
counts that fill no whole block; ``test_capped_two_streams`` launches each
entry on two streams at once (each launch takes a lane counter of its
own).  ``test_fb_carry_edges`` holds the sweep kernel's carry-only body
(its own since the scaled-carry redesign) at one, nine and 2048 markers,
with zeroed rows on its ring's slot edges, dead chains, carries below the
clip and unit counts that fill no block or no 16-byte copy;
``test_relskew_kernel_shapes`` holds csrc/relskew.cu bit for bit at 1, 2,
192 (states in shared memory) and 2048 markers (states in a scratch).  ``test_coherence_matches_plain`` holds
csrc/coherence.cu (all seven slots' coherence in one launch) against its
plain twin on the classic sweeps, on the edge batch (random
canonical-path masks), where the totals vanish (a shift with no mass, a
marker with none, a zero backward row), on an untyped unit, on the
marker-blocked scan's two-column boundary span, at M = 2 and 1 and at a
pair count that fills no whole block (ragged); in float32 held to the
plain twin's accuracy against float64 on the same inputs promoted (its
worst error in units of the tolerance within twice the plain float32
version's, or within the tolerance).  ``test_emission_bmns_matches_plain``
holds the [B, M, NS, S] entry of csrc/emission.cu (routed from
``hmm.emission.scan_blocks``: froot, top, the pathful parent blocks and e)
against ``build_blocks`` + ``assemble_e_all`` on the cohort, on the edge
batch, with every focal a recursion top, at one marker, with an untyped
unit and without e; ``test_turn_bmns_matches_plain`` the [B, M, NS, S]
entry of csrc/turn.cu (routed from ``hmm.probes.turn_weights_fast``)
against ``turn_weights_fast_reference`` on the classic sweeps, at the
edges of ``turn_edge_sweeps`` (those units bit for bit), at one marker and
with an untyped unit.

Run on a machine with the card (tests/conftest.py imports JAX):
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda
Tolerances: float64 rtol=1e-9 (summation order only), float32 rtol=1e-3
(rounding compounded over the marker sweeps).  Turn weights are compared
above a cut, where they are log-ratios of xor-correlations still clear of
the transform's rounding floor, with an absolute slack added: in f32 the
log of the 512-point transform's worst relative rounding at the cut
(eps * 512 * e^5), in f64 1e-10.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch_port_util import (boundary_span, coherence_edge_sweeps, cohort,
                             flat_unit, torch_batch, turn_edge_sweeps)

from cnf2freq_tpu_torch.config import ModelConfig
from cnf2freq_tpu_torch.hmm import probes
from cnf2freq_tpu_torch.hmm.emission import (assemble_e_all, build_blocks,
                                             scan_blocks)
from cnf2freq_tpu_torch.hmm.forward_backward import FBResult, combined_loglik
from cnf2freq_tpu_torch.hmm.transition import (interval_recomb,
                                               transition_eigenvalues)
from cnf2freq_tpu_torch.ops import coherence as pcoh
from cnf2freq_tpu_torch.ops import fb as pfb
from cnf2freq_tpu_torch.ops import scan as ps
from cnf2freq_tpu_torch.ops import stats as pst

pytestmark = pytest.mark.cuda
TOL = {torch.float64: dict(rtol=1e-9, atol=1e-12),
       torch.float32: dict(rtol=1e-3, atol=1e-5)}
TURN = {torch.float64: dict(cut=20.0, slack=1e-10),
        torch.float32: dict(cut=5.0, slack=9.1e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(card, dtype):
    _, fb, dists, cfg, params = cohort(B=37, M=11, seed=9, with_vacant=True)
    fbt = torch_batch(fb).to(card, dtype)
    B, _, M, _ = fbt.md.shape
    st = ps.prep_slots(fbt, dtype)
    d = torch.as_tensor(dists, dtype=dtype, device=card)
    return fbt, st, d, cfg, params, B, M


def _close(got, ref, dtype):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["emission", "fb_sweep", "stats", "turn",
                                    "fb_classic", "stats_bmns"])
def test_kernel_matches_plain(card, kernel, dtype):
    fbt, st, d, cfg, params, B, M = _inputs(card, dtype)
    if kernel in ("fb_classic", "stats_bmns"):
        _check_classic(kernel, fbt, d, cfg, params, dtype)
        return
    e = ps.emission(st, M, cfg)
    if kernel == "emission":
        _close([e], [ps.emission_reference(st, M, cfg)], dtype)
        return
    fb2 = ps.fb_sweeps(e, d, cfg, params)
    if kernel == "fb_sweep":
        _close(fb2, ps.fb_scan_v2(e, d, cfg, params), dtype)
        return
    if kernel == "stats":
        tot = ps.combined_loglik_v2(fb2, st.sh)
        args = (st, fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f, tot, B, cfg)
        _close(pst.stats(*args), pst.stats_reference(*args), dtype)
        return
    desc = fbt.descendants.to(dtype)
    got = ps.turn_weights(fb2, st.sh, desc, cfg, B).cpu().numpy()
    ref = ps.turn_weights_v2(fb2, st.sh, desc, cfg, B).cpu().numpy()
    cut, slack = TURN[dtype]["cut"], TURN[dtype]["slack"]
    keep = ref > -cut
    assert (got[~keep] <= -cut + 1.0).all()
    np.testing.assert_allclose(got[keep], ref[keep], rtol=TOL[dtype]["rtol"],
                               atol=TOL[dtype]["atol"] + slack)


def _check_classic(kernel, fbt, d, cfg, params, dtype):
    """The [B, M, NS, S] kernels of the coherence-carrying scan."""
    e = assemble_e_all(build_blocks(fbt, cfg, dtype=dtype), cfg)
    lam = transition_eigenvalues(cfg, interval_recomb(cfg, params, d))
    got = pfb.fb_sweeps(e, lam)
    if kernel == "fb_classic":
        _close(got, pfb.fb_sweeps_reference(e, lam), dtype)
        return
    fbres = FBResult(*got)
    tot = combined_loglik(fbres, fbt.shiftignore)
    args = (fbt, fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, tot, cfg)
    _close(pst.stats_pallas(*args), pst.stats_bmns_reference(*args), dtype)


def _edge_batch(seed=5, B=37, M=11):
    """The ``_inputs`` family batch (or one of B units and M markers)
    edited so that every branch of root_block, parent_term and gp_term
    occurs: unknown values in every slot, collapsed slots, zero error
    rates, the sex pseudo-allele 9, vacant parents and grandparents, attop
    focals and parents, and random shiftignore and flag2ignore bits.
    Units whose likelihood the edits make zero get their marker data
    back."""
    _, fb, dists, cfg, params = cohort(B=B, M=M, seed=9, with_vacant=True)
    orig = copy.deepcopy(fb)
    rng = np.random.default_rng(seed)
    md, ms = fb.md.copy(), fb.ms.copy()
    md = np.where(rng.uniform(size=md.shape) < 0.2, 0, md)
    # allele 2 renamed 9 at whole (unit, marker)s, which then have no
    # unknown slot (an unknown slot takes no 9)
    nine = rng.uniform(size=(md.shape[0], 1, md.shape[2], 1)) < 0.3
    ms = np.where(nine & (md == 0), 0.2, ms)
    md = np.where(nine, np.where(md == 2, 9, np.maximum(md, 1)), md)
    col = rng.uniform(size=md.shape[:3]) < 0.2
    md[..., 1] = np.where(col, md[..., 0], md[..., 1])
    ms[..., 1] = np.where(col, ms[..., 0], ms[..., 1])
    ms = np.where(rng.uniform(size=ms.shape) < 0.15, 0.0, ms)
    ex, at = fb.exists.copy(), fb.attop.copy()
    B = md.shape[0]
    for b in range(B):
        case = b % 6
        if case == 1:
            ex[b, [1, 2, 3]] = False        # vacant parent 0 and its parents
        elif case == 2:
            ex[b, 5] = False                # one vacant grandparent
        elif case == 3:
            ex[b, 4], at[b, 4] = True, True  # attop parent 1
        elif case == 4:
            at[b, 0] = True                 # attop focal
        elif case == 5:
            ex[b, [2, 6]] = False
            at[b, 1] = True
    fb.md, fb.ms, fb.exists, fb.attop = md.astype(np.int32), ms, ex, at
    fb.flag2ignore = rng.integers(0, 128, B).astype(np.int32)
    fb.shiftignore = rng.integers(0, 8, B).astype(np.int32)
    # restore the marker data of units with likelihood zero (plain f64)
    fbt = torch_batch(fb)
    st = ps.prep_slots(fbt, torch.float64)
    fb2 = ps.fb_sweeps(ps.emission(st, fbt.md.shape[2], cfg),
                       torch.as_tensor(dists), cfg, params)
    dead = (ps.combined_loglik_v2(fb2, st.sh)[:B] < -1e14).numpy()
    fb.md[dead], fb.ms[dead] = orig.md[dead], orig.ms[dead]
    assert dead.sum() < B // 4
    return fb, dists, cfg, params


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["edge", "M1", "R96", "all_attop"])
def test_emission_edge_branches(card, case, dtype):
    """The emission kernel's tables on the edited batch: every branch of
    the block math, one marker, 90 units (R = 96: a ragged last block of
    units), and a batch in which every focal is a recursion top (the
    tops values through the store loop)."""
    B, M = {"M1": (37, 1), "R96": (90, 5)}.get(case, (37, 11))
    fb, _, cfg, _ = _edge_batch(B=B, M=M)
    if case == "all_attop":
        fb.attop = fb.attop.copy()
        fb.attop[:, 0] = True
    fbt = torch_batch(fb).to(card, dtype)
    st = ps.prep_slots(fbt, dtype)
    if case == "R96":
        assert st.R == 96
    ref = ps.emission_reference(st, M, cfg)
    assert bool(torch.isfinite(ref).all())
    _close([ps.emission(st, M, cfg)], [ref], dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["stats", "stats_bmns"])
def test_stats_edge_branches(card, kernel, dtype):
    fb, dists, cfg, params = _edge_batch()
    fbt = torch_batch(fb).to(card, dtype)
    B, _, M, _ = fbt.md.shape
    d = torch.as_tensor(dists, dtype=dtype, device=card)
    if kernel == "stats_bmns":
        _check_classic(kernel, fbt, d, cfg, params, dtype)
        return
    st = ps.prep_slots(fbt, dtype)
    fb2 = ps.fb_sweeps(ps.emission(st, M, cfg), d, cfg, params)
    tot = ps.combined_loglik_v2(fb2, st.sh)
    args = (st, fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f, tot, B, cfg)
    ref = pst.stats_reference(*args)
    assert all(bool(torch.isfinite(r).all()) for r in ref)
    _close(pst.stats(*args), ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["M1", "M2", "R96", "zero_e"])
def test_fb_sweep_edges(card, case, dtype):
    """One or two markers; an R that is a multiple of 32 but not of 64;
    whole shift blocks of e at zero, which take every lane of a chain
    through the MINFACTOR branch and carry zeros into the next step."""
    B, M = {"M1": (37, 1), "M2": (37, 2), "R96": (90, 5),
            "zero_e": (37, 11)}[case]
    _, fb, dists, cfg, params = cohort(B=B, M=M, seed=9, with_vacant=True)
    fbt = torch_batch(fb).to(card, dtype)
    st = ps.prep_slots(fbt, dtype)
    if case == "R96":
        assert st.R == 96
    d = torch.as_tensor(dists, dtype=dtype, device=card)
    e = ps.emission(st, M, cfg)
    dead = [(0, 3), (5, 7)] + [(n, 11) for n in range(8)]  # (shift, unit)
    if case == "zero_e":
        for n, r in dead:
            e[1, n * 64:(n + 1) * 64, r] = 0
    got = ps.fb_sweeps(e, d, cfg, params)
    _close(got, ps.fb_scan_v2(e, d, cfg, params), dtype)
    if case == "zero_e":
        for n, r in dead:
            blk = slice(n * 64, (n + 1) * 64)
            assert (got.fw_post[1, blk, r] == 0).all()
            assert (got.fw_pre[2, blk, r] == 0).all()
            assert (got.bw[0, blk, r] == 0).all()
            for f in (got.fw_post_f[1], got.fw_post_f[2], got.bw_f[0]):
                assert f[n, r] == -1e15


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_turn_edges(card, dtype):
    """Units whose shiftignore masks every shift but 0, and units whose
    sweeps are edited so that D is exactly 0 or negative at offsets (and
    at offset 0) with D[0] > 0 elsewhere: every such entry takes the
    MINFACTOR branch on both sides, exactly."""
    fbt, st, d, cfg, params, B, M = _inputs(card, dtype)
    fb2 = ps.fb_sweeps(ps.emission(st, M, cfg), d, cfg, params)
    sh = st.sh.clone()
    sh[[1, 8, 20]] = 7
    fw_post, bw = fb2.fw_post.clone(), fb2.bw.clone()
    fw_post_f, bw_f = fb2.fw_post_f.clone(), fb2.bw_f.clone()
    exact = [2, 4, 6]
    for r in exact:
        fw_post[:, :, r] = 0
        bw[:, :, r] = 0
        fw_post_f[:, :, r] = 0
        bw_f[:, :, r] = 0
        fw_post[:, 5, r] = 1
    bw[:, 9, 2] = 1                   # D[0] = 0: the whole row
    bw[:, 5, 4] = 1                   # D[0] > 0, D = 0 off offset 0
    bw[:, 5, 6] = 1                   # D[0] > 0, D[12] < 0
    bw[:, 5 ^ 12, 6] = -0.5
    sh[exact] = 0
    fb2 = fb2._replace(fw_post=fw_post, bw=bw, fw_post_f=fw_post_f,
                       bw_f=bw_f)
    desc = fbt.descendants.to(dtype).clone()
    desc[exact] = 2.0
    got = ps.turn_weights(fb2, sh, desc, cfg, B).cpu().numpy()
    ref = ps.turn_weights_v2(fb2, sh, desc, cfg, B).cpu().numpy()
    np.testing.assert_array_equal(got[exact], ref[exact])
    assert (ref[2] == -2e15).all()
    assert (ref[6] == -2e15).any() and (ref[6] == 0).any()
    cut, slack = TURN[dtype]["cut"], TURN[dtype]["slack"]
    keep = ref > -cut
    assert (got[~keep] <= -cut + 1.0).all()
    np.testing.assert_allclose(got[keep], ref[keep], rtol=TOL[dtype]["rtol"],
                               atol=TOL[dtype]["atol"] + slack)


def test_wrapper_counts_and_checks(card):
    fbt, st, d, cfg, params, B, M = _inputs(card, torch.float64)
    before = ps.emission.launches
    ps.emission(st, M, cfg)
    assert ps.emission.launches == before + 1
    with pytest.raises(ValueError):
        ps.emission(st._replace(ms=st.ms.transpose(2, 3)), M, cfg)
    # the kernel takes whole 32-unit quanta only (prep_slots pads to them)
    cut = st._replace(**{f: x[..., :40].contiguous()
                         for f, x in st._asdict().items()})
    with pytest.raises(RuntimeError):
        ps.emission(cut, M, cfg)
    assert ps.emission.launches == before + 1
    e = assemble_e_all(build_blocks(fbt, cfg), cfg)
    lam = transition_eigenvalues(cfg, interval_recomb(cfg, params, d))
    before = pfb.fb_sweeps.launches
    pfb.fb_sweeps(e, lam)
    assert pfb.fb_sweeps.launches == before + 1
    with pytest.raises(ValueError):
        pfb.fb_sweeps(e.transpose(0, 1), lam)


def _seeded_carry(gen, R, dtype, card):
    return (torch.rand((512, R), generator=gen, dtype=dtype, device=card),
            torch.randn((8, R), generator=gen, dtype=dtype, device=card) * 3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["init", "carry_fwd", "carry_bwd",
                                  "carry_default", "chunk"])
def test_fb_sweep_blocked(card, mode, dtype):
    """Kernel #2 with seeded boundary carries, and in carry-only mode
    forward, backward (through a lam_below row) and from the default
    seeds, against the plain twins; the whole blocked chunk scan (block 3
    of 11 markers, padded to 12) on the card against the CPU."""
    fbt, st, d, cfg, params, B, M = _inputs(card, dtype)
    e = ps.emission(st, M, cfg)
    lam = ps.sweep_eigenvalues(d, cfg, params, dtype)
    gen = torch.Generator(device=card).manual_seed(3)
    fwd, bwd = (_seeded_carry(gen, st.R, dtype, card) for _ in range(2))
    if mode == "init":
        before = ps.fb_sweeps.launches
        got = ps.fb_sweeps(e, None, cfg, None, lam_pad=lam, init_fwd=fwd,
                           init_bwd=bwd)
        assert ps.fb_sweeps.launches == before + 1
        _close(got, ps.fb_scan_v2_block(e, lam, *fwd, *bwd, cfg), dtype)
    elif mode == "carry_fwd":
        before = ps.fb_carry.launches
        got = ps.fb_carry(e, lam, cfg, init=fwd)
        assert ps.fb_carry.launches == before + 1
        _close(got, ps.fb_carry_fwd(e, lam, *fwd, cfg), dtype)
    elif mode == "carry_bwd":
        got = ps.fb_carry(e, lam, cfg, init=bwd, backward=True,
                          lam_below=lam[3])
        _close(got, ps.fb_carry_bwd(e, lam, lam[3], *bwd, cfg), dtype)
    elif mode == "carry_default":
        R = st.R
        for backward in (False, True):
            seed = ps.sweep_seeds(512, R, cfg, dtype, card, backward)
            got = ps.fb_carry(e, lam, cfg, backward=backward)
            ref = ps.fb_carry(e.cpu(), lam.cpu(), cfg,
                              init=tuple(x.cpu() for x in seed),
                              backward=backward)
            _close(got, ref, dtype)
    else:
        from cnf2freq_tpu_torch.parallel.mesh import pad_markers
        fb12 = pad_markers(fbt, 12)
        d12 = torch.cat([d, torch.zeros(1, dtype=dtype, device=card)])
        NI = int(fbt.slot_ind.max()) + 1
        lut = torch.arange(NI + 1, device=card)
        got = ps.blocked_scan_chunk(fb12, d12, None, lut, cfg, params, 3, NI)
        ref = ps.blocked_scan_chunk(fb12.to("cpu", dtype), d12.cpu(), None,
                                    lut.cpu(), cfg, params, 3, NI)
        _close(got, ref, dtype)


def test_fb_sweep_blocked_checks(card):
    """The blocked entries refuse carries of the wrong shape, a CPU lam
    row, and count nothing then."""
    fbt, st, d, cfg, params, B, M = _inputs(card, torch.float64)
    e = ps.emission(st, M, cfg)
    lam = ps.sweep_eigenvalues(d, cfg, params, torch.float64)
    bad = (torch.ones((512, st.R + 32), dtype=torch.float64, device=card),
           torch.zeros((8, st.R + 32), dtype=torch.float64, device=card))
    before = (ps.fb_sweeps.launches, ps.fb_carry.launches)
    with pytest.raises(ValueError):
        ps.fb_sweeps(e, None, cfg, None, lam_pad=lam, init_fwd=bad)
    with pytest.raises(ValueError):
        ps.fb_carry(e, lam, cfg, init=bad)
    with pytest.raises(ValueError):
        ps.fb_carry(e, lam, cfg, backward=True, lam_below=lam[0].cpu())
    assert (ps.fb_sweeps.launches, ps.fb_carry.launches) == before


def _rules_inputs(card, dtype):
    """The slice's 1000 x 192 cohort (chip_smoke.py's kernel_inputs) with
    four probe-dedup variants, in both layouts: (fbt, st, v2 sweeps and
    total, [B, M, NS, S] sweeps and total, cfg, B, M)."""
    from cnf2freq_tpu_torch.config import ModelConfig, RuntimeParams
    from cnf2freq_tpu_torch.hmm.family import gather_family
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    ped = simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20, seed=7)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1,
                       n_variants=4)
    rng = np.random.default_rng(7)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    fbt = fb.to(card, dtype)
    cfg, params = ModelConfig(), RuntimeParams()
    B, _, M, _ = fbt.md.shape
    d = torch.as_tensor(np.diff(ped.markerposes), dtype=dtype, device=card)
    st = ps.prep_slots(fbt, dtype)
    fb2 = ps.fb_sweeps(ps.emission(st, M, cfg), d, cfg, params)
    v2 = (fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f,
          ps.combined_loglik_v2(fb2, st.sh))
    bmns = (ps.to_std(fb2.fw_pre, B, cfg).contiguous(),
            ps.to_std(fb2.bw, B, cfg).contiguous(),
            ps.to_std_f(fb2.fw_pre_f, B).contiguous(),
            ps.to_std_f(fb2.bw_f, B).contiguous(), v2[4][:B].contiguous())
    return fbt, st, v2, bmns, cfg, B, M


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["v2", "bmns"])
@pytest.mark.parametrize("case", ["variants", "df_zero"])
def test_stats_rules_match_plain(card, case, layout, dtype):
    """The probe-rule entries of csrc/stats.cu (one launch per dup-flip
    variant) against their plain twins at the slice's 1000 x 192 shape.
    df_zero: every dup-flip column zero; the entry then equals its plain
    twin with the empty-slot flags applied, and with every slot marked
    empty as well (no factor left) the entry without probe rules."""
    fbt, st, v2, bmns, cfg, B, M = _rules_inputs(card, dtype)
    assert fbt.dup_flip.shape[1] == 4
    if case == "df_zero":
        fbt.dup_flip = torch.zeros_like(fbt.dup_flip)
        st = st._replace(df=torch.zeros_like(st.df))
    if layout == "v2":
        before = pst.stats_rules.launches
        for v in range(4):
            _close(pst.stats_rules(st, v, *v2, B, cfg),
                   pst.stats_reference(st, *v2, B, cfg, em=st.em,
                                       df=st.df[v], rules=True), dtype)
        _close(pst.stats(st, *v2, B, cfg, probe_rules=True, n_variants=4),
               [sum(p) / 4 for p in zip(*(
                   pst.stats_reference(st, *v2, B, cfg, em=st.em,
                                       df=st.df[v], rules=True)
                   for v in range(4)))], dtype)
        assert pst.stats_rules.launches == before + 8
        if case == "df_zero":
            full = st._replace(em=torch.ones_like(st.em))
            _close(pst.stats_rules(full, 0, *v2, B, cfg),
                   pst.stats(st, *v2, B, cfg), dtype)
        return
    before = pst.stats_bmns_rules.launches
    for v in range(4):
        _close(pst.stats_bmns_rules(fbt, v, *bmns, cfg),
               pst.stats_bmns_reference(fbt, *bmns, cfg, em=fbt.emptyslot,
                                        df=fbt.dup_flip[:, v], rules=True),
               dtype)
    assert pst.stats_bmns_rules.launches == before + 4
    if case == "df_zero":
        import dataclasses
        full = dataclasses.replace(
            fbt, emptyslot=torch.ones_like(fbt.emptyslot))
        _close(pst.stats_bmns_rules(full, 0, *bmns, cfg),
               pst.stats_pallas(fbt, *bmns, cfg), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_merges_reproduce(card, dtype):
    """The accumulator merges and the flip scorer's pattern sums add in
    index order on the card (``ordered_sums``): two calls give the same
    bits, and the same bits as the CPU's sums of the same terms."""
    from cnf2freq_tpu_torch.parallel.collective import _segment_sum
    from cnf2freq_tpu_torch.updates.scatter import ordered_sums
    rng = np.random.default_rng(5)
    rows = torch.as_tensor(rng.integers(0, 301, 7000))
    vals = torch.as_tensor(rng.random((7000, 64, 2, 2)), dtype=dtype)
    host = _segment_sum(vals, rows, 300)
    got = [_segment_sum(vals.to(card), rows.to(card), 300).cpu()
           for _ in range(2)]
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], host)
    idx = torch.as_tensor(rng.integers(0, 16, (50, 1, 128))).expand(
        50, 64, 128)
    w = torch.as_tensor(rng.random((50, 64, 128)), dtype=dtype)
    host = torch.zeros_like(w).scatter_add_(2, idx, w)
    with ordered_sums():
        got = [torch.zeros_like(w.to(card)).scatter_add_(
            2, idx.to(card), w.to(card)).cpu() for _ in range(2)]
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], host)


# markers on which a staged tile of 16, 32 or 64 markers starts or ends
TILE_EDGES = (15, 16, 31, 32, 63, 64)
# a value that float64 holds below the XLA scan's 1e-300 clip
TINY = 1e-302


def _small_inputs(card, dtype, NS, M, zero_rows=False, seed=13, B=37,
                  edges=False, tiny=False):
    """e [B, M, NS, 4] and lam [M-1, 4] of a 4-state family, made with
    numpy; ``zero_rows`` zeroes whole emission rows (every state of a
    (unit, marker, shift)), so that a sweep meets a zero sum
    (MINFACTOR) and restarts from zeros; ``edges`` zeroes whole rows of
    units 3 and 4 on the markers of TILE_EDGES; ``tiny`` (M >= 7) scales
    the interval leaving marker 5 by TINY, so that every carry crossing
    it holds values below the clip (in float64; 0 in float32): the clip
    zeroes them and the rows die (MINFACTOR), where without it they
    would live on."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(0.0, 1.0, (B, M, NS, 4))
    e[rng.random((B, M, NS, 4)) < 0.2] = 0.0
    if zero_rows:
        e[rng.random((B, M, NS)) < 0.15] = 0.0
        e[0, :, 0] = 0.0
    lam = np.prod(np.where(((np.arange(4)[:, None] >> np.arange(2)) & 1)
                           == 1, 1.0 - 2.0 * rng.uniform(
                               0.0, 0.4, (max(M - 1, 0), 1, 2)), 1.0),
                  axis=-1)
    if edges:
        for m in TILE_EDGES:
            if m < M:
                e[3:5, m] = 0.0
    if tiny:
        lam[5] *= TINY
    return (torch.as_tensor(e, dtype=dtype, device=card),
            torch.as_tensor(lam, dtype=dtype, device=card))


# (markers, units, edit of _small_inputs / _ext_inputs): one and two
# markers; zeroed emission rows; M not a multiple of the staged tile
# depth, with zeroed rows on tile boundaries; values below the clip, in
# fewer units than a block takes
SMALL_CASES = {"M1": (1, 37, {}), "M2": (2, 37, {}),
               "zero_rows": (23, 37, dict(zero_rows=True)),
               "tile_edges": (69, 37, dict(edges=True)),
               "tiny": (41, 5, dict(tiny=True))}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("NS", [1, 2])
@pytest.mark.parametrize("case", list(SMALL_CASES))
def test_fb_small_matches_plain(card, case, NS, dtype):
    """The 4-state entry (csrc/fb_small.cu) against its plain twin at the
    XLA scan's clip, NS = 1 (nohaplo) and NS = 2 (ng2), in the cases of
    SMALL_CASES; zeroed rows and values below the clip must reach
    MINFACTOR, and without the clip the tiny case's float64 rows would
    not."""
    M, B, edit = SMALL_CASES[case]
    e, lam = _small_inputs(card, dtype, NS, M, B=B, **edit)
    before = pfb.fb_sweeps_small.launches
    got = pfb.fb_sweeps(e, lam, pfb.XLA_CLIP)
    assert pfb.fb_sweeps_small.launches == before + 1
    ref = pfb.fb_sweeps_reference(e, lam, pfb.XLA_CLIP)
    _close(got, ref, dtype)
    if case in ("zero_rows", "tile_edges", "tiny"):
        assert (got[4] == -1e15).any()
    if case == "tiny" and dtype == torch.float64:
        unclipped = pfb.fb_sweeps_reference(e, lam, 0.0)
        assert not torch.equal(unclipped[4], ref[4])
        assert not torch.equal(unclipped[5], ref[5])


def test_fb_small_wrapper_checks(card):
    """An unsupported (NS, S) on the card raises; the 64-state entry keeps
    its own clip."""
    e, lam = _small_inputs(card, torch.float64, 2, 5)
    for bad in (torch.zeros((3, 5, 4, 4), dtype=torch.float64, device=card),
                torch.zeros((3, 5, 2, 8), dtype=torch.float64, device=card)):
        with pytest.raises(ValueError):
            pfb.fb_sweeps(bad, lam)
    with pytest.raises(ValueError):
        pfb.fb_sweeps_small(torch.zeros((3, 5, 8, 64), dtype=torch.float64,
                                        device=card),
                            torch.zeros((4, 64), dtype=torch.float64,
                                        device=card))
    before = (pfb.fb_sweeps.launches, pfb.fb_sweeps_small.launches)
    with pytest.raises(ValueError):
        pfb.fb_sweeps(e.transpose(0, 1), lam)
    assert (pfb.fb_sweeps.launches, pfb.fb_sweeps_small.launches) == before


def _ext_inputs(card, dtype, V, M, zero_rows=False, seed=13, B=5, NS=8,
                edges=False, tiny=False):
    """Random extended sweep inputs: e [B, M, V, NS, 64] with zeros, lam
    from random recombination rates, a random row-stochastic (so not
    symmetric) coupling [B, M-1, V, V] and a prior [B, V]; ``edges`` zeroes
    every row of unit 3 and shift 1's of unit 4 on the markers of
    TILE_EDGES; ``tiny`` (M >= 13, B >= 3) scales unit 1's coupling of
    the interval leaving marker 5 and unit 2's of the one below marker
    M - 6 by TINY, so that unit 1's forward and unit 2's backward carry
    cross them with values below the clip (in float64; 0 in float32):
    the clip zeroes them and the rows die (MINFACTOR)."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(0.0, 1.0, (B, M, V, NS, 64))
    e[rng.random(e.shape) < 0.2] = 0.0
    if zero_rows:
        e[:, M // 2, :, min(3, NS - 1)] = 0.0
    r = rng.uniform(0.0, 0.3, (max(M - 1, 0), 6))
    bits = (np.arange(64)[:, None] >> np.arange(6)[None, :]) & 1
    lam = np.where(bits[None] == 1, 1 - 2 * r[:, None, :], 1.0).prod(-1)
    C = rng.uniform(0.05, 1.0, (B, max(M - 1, 0), V, V))
    C /= C.sum(-1, keepdims=True)
    prior = rng.uniform(0.1, 1.0, (B, V)) / (64 * V)
    if edges:
        for m in TILE_EDGES:
            if m < M:
                e[3, m] = 0.0
                e[4, m, :, min(1, NS - 1)] = 0.0
    if tiny:
        C[1, 5] *= TINY
        C[2, M - 7] *= TINY

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=card)
    return t(e), t(lam), t(C), t(prior)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("V", [2, 3])
@pytest.mark.parametrize("case", ["M1", "M2", "zero_rows", "M40"])
def test_fb_ext_matches_plain(card, case, V, dtype):
    """The extended sweeps (csrc/fb_ext.cu) against their plain twin at
    the XLA scan's clip: one and two markers, an emission row of zeros
    (MINFACTOR) and 40 markers, V = 2 (RELSKEWSTATES) and 3 (SELFING),
    with a non-symmetric coupling (the backward sweep's orientation)."""
    M = {"M1": 1, "M2": 2, "zero_rows": 23, "M40": 40}[case]
    e, lam, C, prior = _ext_inputs(card, dtype, V, M,
                                   zero_rows=case == "zero_rows")
    before = pfb.fb_ext.launches
    got = pfb.fb_ext(e, lam, C, prior)
    assert pfb.fb_ext.launches == before + 1
    ref = pfb.fb_ext_reference(e, lam, C, prior)
    _close(got, ref, dtype)
    if case == "zero_rows":
        assert (got[4] == -1e15).any()


def test_fb_ext_wrapper_checks(card):
    """V outside {2, 3}, a state axis other than 64 and a non-contiguous
    e raise on the card without a launch."""
    e, lam, C, prior = _ext_inputs(card, torch.float64, 3, 5)
    before = pfb.fb_ext.launches
    with pytest.raises(ValueError):
        pfb.fb_ext(e[:, :, :1].expand(-1, -1, 4, -1, -1), lam,
                   C[:, :, :1, :1].expand(-1, -1, 4, 4), prior[:, :1].expand(
                       -1, 4))
    with pytest.raises(ValueError):
        pfb.fb_ext(e[..., :32], lam[:, :32], C, prior)
    with pytest.raises(ValueError):
        pfb.fb_ext(e.transpose(0, 1), lam, C, prior)
    assert pfb.fb_ext.launches == before


def _random_carry(rng, shape, card, dtype):
    """A boundary carry (p of ``shape``, f [B, NS]) drawn with numpy."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=card)
    return (t(rng.uniform(0.0, 1.0, shape)),
            t(rng.normal(0.0, 3.0, (shape[0], shape[-2]))))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("NS", [1, 2])
@pytest.mark.parametrize("case", ["K1", "K9", "zero_rows", "tile_edges",
                                  "tiny"])
def test_fb_small_carries_match_plain(card, case, NS, dtype):
    """The 4-state entries of the families' marker-blocked scan
    (csrc/fb_small.cu): both sweeps from random boundary carries
    (fb_small_block) and carry-only forward and backward with an
    interval below the block (fb_small_carry), against their plain twins
    at the XLA scan's clip, at one and nine markers, with zeroed emission
    rows, at K = 69 with zeroed rows on tile boundaries (K not a multiple
    of a tile) and with values below the clip in 5 units (tiny, as in
    SMALL_CASES); each wrapper counts its launches."""
    K, B, edit = {"K1": (1, 37, {}), "K9": (9, 37, {}),
                  "zero_rows": (23, 37, dict(zero_rows=True)),
                  "tile_edges": (69, 37, dict(edges=True)),
                  "tiny": (41, 5, {})}[case]
    e, lam = _small_inputs(card, dtype, NS, K + 2, B=B, **edit)
    e = e[:, :K].contiguous()
    lam_pad, below = lam[:K].contiguous(), lam[K].contiguous()
    rng = np.random.default_rng(21)
    fwd, bwd = (_random_carry(rng, (B, NS, 4), card, dtype)
                for _ in range(2))
    if case == "tiny":
        # unit 1's forward and unit 2's backward carry enter with
        # values below the clip beside one large state, which the first
        # emission takes away (no other zero of e in those units ends
        # either row)
        tiny_row = torch.tensor([1.0, TINY, TINY, TINY], dtype=dtype)
        fwd[0][1], bwd[0][2] = tiny_row, tiny_row
        e[1:3].clamp_(min=0.05)
        e[1, 0] = e[2, K - 1] = torch.tensor([0.0, 1.0, 1.0, 1.0])
    before = (pfb.fb_small_block.launches, pfb.fb_small_carry.launches)
    got = pfb.fb_small_block(e, lam_pad, fwd, bwd)
    carries = (pfb.fb_small_carry(e, lam_pad, fwd) +
               pfb.fb_small_carry(e, lam_pad, bwd, backward=True,
                                  lam_below=below))
    assert (pfb.fb_small_block.launches, pfb.fb_small_carry.launches) == \
        (before[0] + 1, before[1] + 2)
    clip = pfb.XLA_CLIP
    _close(got, pfb.fb_block_reference(e, lam_pad, *fwd, *bwd, clip), dtype)
    ref = (pfb.fb_carry_reference(e, lam_pad, *fwd, clip) +
           pfb.fb_carry_reference(e, lam_pad, *bwd, clip, backward=True,
                                  lam_below=below))
    _close(carries, ref, dtype)
    if case == "tiny":
        assert bool((carries[1][1] == -1e15).all())
        assert bool((carries[3][2] == -1e15).all())
        if dtype == torch.float64:
            assert not torch.equal(
                pfb.fb_carry_reference(e, lam_pad, *fwd, 0.0)[1], ref[1])
    # the whole-chromosome seeds give the whole sweep (whose stores do
    # not read the last interval row)
    _close(pfb.fb_small_block(e, lam_pad),
           pfb.fb_sweeps_reference(e, lam_pad[:-1], clip), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("V", [2, 3])
@pytest.mark.parametrize("case", ["K1", "K9", "zero_rows", "tile_edges",
                                  "tiny", "NS3"])
def test_fb_ext_carries_match_plain(card, case, V, dtype):
    """The extended entries of the marker-blocked scan (csrc/fb_ext.cu):
    both sweeps from random [B, V, NS, 64] boundary carries (fb_ext_block)
    and carry-only forward and backward (fb_ext_carry), the backward
    step below the block through a random row-stochastic coupling (so
    not symmetric: the from -> to orientation shows), against their
    plain twins, V = 2 and 3: at one and nine markers, with zeroed
    emission rows, at K = 69 with zeroed rows on the boundaries of the
    staged interval tiles, with values below the clip (tiny, as in
    SMALL_CASES), and with 3 shifts, so that the 15 (unit, shift) chains
    fill no warp; each wrapper counts its launches."""
    K, NS, edit = {"K1": (1, 8, {}), "K9": (9, 8, {}),
                   "zero_rows": (23, 8, dict(zero_rows=True)),
                   "tile_edges": (69, 8, dict(edges=True)),
                   "tiny": (41, 8, dict(tiny=True)),
                   "NS3": (41, 3, dict(zero_rows=True))}[case]
    e, lam, C, _ = _ext_inputs(card, dtype, V, K + 2, NS=NS, **edit)
    e = e[:, :K].contiguous()
    lam_pad, C_pad = lam[:K].contiguous(), C[:, :K].contiguous()
    lam_below, C_below = lam[K].contiguous(), C[:, K].contiguous()
    rng = np.random.default_rng(22)
    B = e.shape[0]
    fwd, bwd = (_random_carry(rng, (B, V, NS, 64), card, dtype)
                for _ in range(2))
    before = (pfb.fb_ext_block.launches, pfb.fb_ext_carry.launches)
    got = pfb.fb_ext_block(e, lam_pad, C_pad, fwd, bwd)
    carries = (pfb.fb_ext_carry(e, lam_pad, C_pad, fwd) +
               pfb.fb_ext_carry(e, lam_pad, C_pad, bwd, backward=True,
                                lam_below=lam_below, C_below=C_below))
    assert (pfb.fb_ext_block.launches, pfb.fb_ext_carry.launches) == \
        (before[0] + 1, before[1] + 2)
    clip = pfb.XLA_CLIP
    _close(got, pfb.fb_ext_block_reference(e, lam_pad, C_pad, *fwd, *bwd,
                                           clip), dtype)
    _close(carries,
           pfb.fb_ext_carry_reference(e, lam_pad, C_pad, *fwd, clip) +
           pfb.fb_ext_carry_reference(e, lam_pad, C_pad, *bwd, clip,
                                      backward=True, lam_below=lam_below,
                                      C_below=C_below), dtype)
    if case == "tiny":
        assert bool((carries[1][1] == -1e15).all())
        assert bool((carries[3][2] == -1e15).all())
        if dtype == torch.float64:
            unclipped = pfb.fb_ext_carry_reference(e, lam_pad, C_pad, *fwd,
                                                   0.0)
            assert not torch.equal(unclipped[1], carries[1])


def _update_lanes(card, monkeypatch, entry, dtype, M, sf, N=12):
    """The lane arguments that update_haploweights / update_infprobs hand
    ``entry`` on the card, from torch_update_util's inputs with their edge
    lanes (the kernel's own results discarded)."""
    from torch_update_util import haplo_inputs, infprob_inputs

    from cnf2freq_tpu_torch.config import RuntimeParams
    from cnf2freq_tpu_torch.updates import capped as pcap
    from cnf2freq_tpu_torch.updates import parameter_updates as ppu
    seen = []
    real = getattr(pcap, entry)
    monkeypatch.setattr(ppu, entry, lambda *a: seen.append(a) or real(*a))
    make, update = ((haplo_inputs, ppu.update_haploweights)
                    if entry == "capped_haplo" else
                    (infprob_inputs, ppu.update_infprobs))

    def dev(x):
        x = torch.as_tensor(np.array(x))
        return x.to(card, dtype) if x.is_floating_point() else x.to(card)
    update(*(dev(x) for x in make(N=N, M=M)), RuntimeParams(), sf)
    return seen[0]


def _same(got, ref):
    """Bit for bit, NaN where NaN."""
    return torch.equal(got.isnan(), ref.isnan()) and \
        torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sf", [0.013, 0.0])
@pytest.mark.parametrize("M", [1, 2, 11])
@pytest.mark.parametrize("entry", ["capped_haplo", "capped_infprob"])
def test_capped_matches_plain(card, monkeypatch, entry, M, sf, dtype):
    """csrc/capped.cu against the plain version on the card, on the edge
    lanes of torch_update_util (flat, NaN gradients, eps and 1 - eps,
    breakathalf, no mass): the same values bit for bit, the same hits, one
    launch."""
    from cnf2freq_tpu_torch.updates import capped as pcap
    args = _update_lanes(card, monkeypatch, entry, dtype, M, sf)
    fn = getattr(pcap, entry)
    before = fn.launches
    v, hit = fn(*args)
    assert fn.launches == before + 1
    rv, rhit = getattr(pcap, entry + "_reference")(*args)
    torch.cuda.synchronize()
    assert _same(v, rv)
    assert torch.equal(hit, rhit)


# torch_update_util's edge rows: haploweights 0 eps, 1 1 - eps, 2-3 flat,
# 4 NaN gradients, 5-6 breakathalf; genotypes 0 eps and 1 - eps, 1-2 flat,
# 3 a NaN mass, 4 no mass
EDGE_ROWS = {"capped_haplo": 7, "capped_infprob": 5}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sf", [0.013, 0.0])
@pytest.mark.parametrize("rows", [1, 33, 4097])
@pytest.mark.parametrize("entry", ["capped_haplo", "capped_infprob"])
def test_capped_divergent_lanes(card, monkeypatch, entry, rows, sf, dtype):
    """csrc/capped.cu walks each thread's lanes one bisection step at a
    time, so lanes that stop at very different steps share a warp: rows of
    one lane (genotypes: one row's 4 lanes) drawn from a pool of 4,096
    (torch_update_util's edge rows and random ones), every other row one
    whose plain bisection runs the pool's most steps (all 51 where the
    pool has such rows: a lane beside a near-double root of its gradient,
    rare in float64 genotypes), between them the edge rows (eps, 1 - eps,
    flat, NaN gradients, breakathalf, no mass) and random ones; lane
    counts of 1, 33 and 4,097 (genotypes 4, 132 and 4,100, at most 1,025
    rows), no multiple of a block or of the grid's threads.  Values and
    hits bit for bit the plain version's, one launch."""
    import chip_smoke

    from cnf2freq_tpu_torch.updates import capped as pcap
    pool = _update_lanes(card, monkeypatch, entry, dtype, 1, 0.013, N=4096)
    reference = getattr(pcap, entry + "_reference")
    _, steps = chip_smoke.plain_lane_steps(reference, pool)
    per_row = steps.reshape(4096, -1).amax(dim=1).cpu()
    long_rows = torch.nonzero(per_row == per_row.max()).flatten()
    edge_rows = torch.arange(EDGE_ROWS[entry])
    other = torch.arange(EDGE_ROWS[entry], 4096)
    n = min(rows, 1025) if entry == "capped_infprob" else rows
    k = torch.arange(n)
    idx = torch.where(k % 2 == 0, long_rows[(k // 2) % len(long_rows)],
                      torch.where(k % 4 == 1, edge_rows[(k // 4) %
                                                        len(edge_rows)],
                                  other[(k * 37) % len(other)])).to(card)
    args = tuple(x[idx] if torch.is_tensor(x) else x for x in pool[:-1]) + \
        (sf,)
    fn = getattr(pcap, entry)
    before = fn.launches
    v, hit = fn(*args)
    assert fn.launches == before + 1
    rv, rhit = reference(*args)
    torch.cuda.synchronize()
    assert v.numel() == (n if entry == "capped_haplo" else 4 * n)
    assert _same(v, rv)
    assert torch.equal(hit, rhit)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M", [1, 2, 11])
def test_relskew_matches_plain(card, M, dtype):
    """csrc/relskew.cu against the plain version on the card, reading a
    chromosome's columns of wider tensors in place, with rows whose mass
    is rescaled: the same ratios bit for bit."""
    from torch_update_util import relskew_inputs

    from cnf2freq_tpu_torch.updates import relskew as prs
    hw, rh = relskew_inputs(N=45, M=M)
    wide = [torch.as_tensor(np.concatenate([x, np.full((45, 5), 0.3)], 1),
                            dtype=dtype, device=card) for x in (hw, rh)]
    before = prs.relskew_ratio.launches
    got = prs.relskew_ratio(wide[0][:, 2:2 + M], wide[1][:, 2:2 + M])
    assert prs.relskew_ratio.launches == before + 1
    ref = prs.relskew_ratio_reference(wide[0][:, 2:2 + M],
                                      wide[1][:, 2:2 + M])
    torch.cuda.synchronize()
    assert _same(got, ref)


# the carry-only entry's cases: (K markers, R units); its ring holds 3
# markers in float32 and 2 in float64 (csrc/fb_sweep.cu's CarryStages), a
# block 32 units in either type
CARRY_CASES = {"K1": (1, 64), "K9": (9, 64), "K2048": (2048, 64),
               "zero_rows": (23, 64), "tiny": (23, 64), "dead": (23, 64),
               "R36": (9, 36), "R37": (9, 37)}


def _carry_case(card, dtype, case):
    """e [K, 512, R] from U(0.05, 1), the eigenvalue rows of K + 1 random
    intervals (the first the one below the block), random carries, all
    drawn with numpy; the case's edits."""
    from cnf2freq_tpu_torch.config import ModelConfig, RuntimeParams
    K, R = CARRY_CASES[case]
    cfg = ModelConfig()
    rng = np.random.default_rng(31)
    e = rng.uniform(0.05, 1.0, (K, 512, R))
    dists = torch.as_tensor(rng.uniform(0.05, 2.0, K + 1), dtype=dtype,
                            device=card)
    rows = ps.sweep_eigenvalues(dists, cfg, RuntimeParams(), dtype)
    carries = [[rng.uniform(0.0, 1.0, (512, R)),
                rng.normal(0.0, 3.0, (8, R))] for _ in range(2)]
    dead = []
    if case == "zero_rows":
        # zero states of some rows on the ring's slot edges (markers 0-3),
        # and the last marker
        for m in (0, 1, 2, 3, K - 1):
            e[m, rng.choice(512, 40, replace=False), rng.integers(0, R)] = 0
    elif case == "dead":
        # whole shift blocks of e at zero: the (shift, unit) chain dies
        # in both directions (zeros and MINFACTOR)
        dead = [(0, 0, 0), (2, 3, 5), (7, R - 1, 2), (5, 17, K - 1)]
        for n, r, m in dead:
            e[m, n * 64:(n + 1) * 64, r] = 0
    elif case == "tiny":
        # carries entering with values below the clip (float64: 1e-300;
        # float32: 0, negative rounding residue) beside large ones
        low = TINY if dtype == torch.float64 else -1e-7
        for p, _ in carries:
            p[rng.choice(512, 100, replace=False), 1] = low
            p[:64, 2] = low
            p[0, 2] = 1.0

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=card)
    return (t(e), rows[1:K + 1].contiguous(), rows[0].contiguous(),
            [tuple(t(x) for x in c) for c in carries], dead)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CARRY_CASES))
def test_fb_carry_edges(card, case, dtype):
    """The carry-only entry of csrc/fb_sweep.cu (passes A and B of the
    blocked scan), forward and backward (through the interval below the
    block), against fb_carry_fwd / fb_carry_bwd: one and nine markers; a
    2048-marker block, whose scaled carry sums some 2,000 exponents into
    its log-factor; zeroed e rows on the ring's slot edges; carries
    entering below the clip; dead (unit, shift) chains, which end at
    zeros and MINFACTOR; units that fill no whole block (36); rows of
    units that fill no whole 16-byte copy (37), which the entry refuses
    (it stages e by 16-byte copies), counting nothing."""
    import chip_smoke
    e, lam, below, (fwd, bwd), dead = _carry_case(card, dtype, case)
    cfg = ModelConfig()
    before = ps.fb_carry.launches
    if case == "R37":
        with pytest.raises(RuntimeError):
            ps.fb_carry(e, lam, cfg, init=fwd)
        with pytest.raises(RuntimeError):
            ps.fb_carry(e, lam, cfg, init=bwd, backward=True,
                        lam_below=below)
        assert ps.fb_carry.launches == before
        return
    got = (ps.fb_carry(e, lam, cfg, init=fwd) +
           ps.fb_carry(e, lam, cfg, init=bwd, backward=True,
                       lam_below=below))
    assert ps.fb_carry.launches == before + 2
    ref = (ps.fb_carry_fwd(e, lam, *fwd, cfg) +
           ps.fb_carry_bwd(e, lam, below, *bwd, cfg))
    ref64 = None
    if dtype == torch.float32:
        d64 = [x.double() for x in (e, lam, below)]
        ref64 = (ps.fb_carry_fwd(d64[0], d64[1],
                                 *(x.double() for x in fwd), cfg) +
                 ps.fb_carry_bwd(*d64, *(x.double() for x in bwd), cfg))
    torch.cuda.synchronize()
    # float64: the tolerance; float32: chip_smoke.py's rule, the kernel's
    # worst error against float64 within twice the plain float32 twin's
    assert chip_smoke.as_accurate(ref64)(got, ref, dtype)[2]
    for n, r, _ in dead:
        for p, f in (got[:2], got[2:]):
            assert bool((p[n * 64:(n + 1) * 64, r] == 0).all())
            assert bool(f[n, r] == -1e15)


def test_fb_carry_refuses(card):
    """The carry-only entry refuses misaligned eigenvalue rows and a
    misaligned e (it stages both by 16-byte copies) and counts nothing
    then."""
    e, lam, below, (fwd, _), _ = _carry_case(card, torch.float32, "K9")
    cfg = ModelConfig()
    before = ps.fb_carry.launches
    off = torch.empty(65, dtype=torch.float32, device=card)[1:]
    off.copy_(below)
    with pytest.raises(RuntimeError):
        ps.fb_carry(e, lam, cfg, init=fwd, backward=True, lam_below=off)
    e_off = torch.empty(e.numel() + 1, dtype=e.dtype, device=card)[1:]
    e_off = e_off.view(e.shape).copy_(e)
    with pytest.raises(RuntimeError):
        ps.fb_carry(e_off, lam, cfg, init=fwd)
    assert ps.fb_carry.launches == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M", [1, 2, 192, 2048])
def test_relskew_kernel_shapes(card, M, dtype):
    """csrc/relskew.cu (forward and backward at once, meeting in the
    middle) at one and two markers, at the resident slice's 192 (stored
    states in shared memory) and the blocked slice's 2048 (stored states
    in a device scratch), on 77 rows (no multiple of a block's 32), read as
    the columns 3 .. 3 + M of wider tensors, with rows whose mass falls
    below 1e-10 (at 192 and 2048 markers): the plain version's ratios bit
    for bit."""
    from torch_update_util import forward_rescales, relskew_inputs

    from cnf2freq_tpu_torch.updates import relskew as prs
    hw, rh = relskew_inputs(N=77, M=M)
    if M > 3:
        assert forward_rescales(hw, rh)[:2].all()
    wide = [torch.as_tensor(np.concatenate([np.full((77, 3), 0.7), x,
                                            np.full((77, 5), 0.3)], 1),
                            dtype=dtype, device=card) for x in (hw, rh)]
    cols = [x[:, 3:3 + M] for x in wide]
    assert cols[0].stride(0) == M + 8
    before = prs.relskew_ratio.launches
    got = prs.relskew_ratio(*cols)
    assert prs.relskew_ratio.launches == before + 1
    ref = prs.relskew_ratio_reference(*cols)
    torch.cuda.synchronize()
    assert _same(got, ref)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_capped_two_streams(card, monkeypatch, dtype):
    """csrc/capped.cu's launches each take their lanes from a counter of
    their own: each entry launched on two streams at once, on different
    lanes (4,096 rows and the same rows reversed), and the two entries on
    two streams at once; every result the plain version's bit for bit."""
    from cnf2freq_tpu_torch.updates import capped as pcap
    pools = {entry: _update_lanes(card, monkeypatch, entry, dtype, 1,
                                  0.013, N=4096)
             for entry in ("capped_haplo", "capped_infprob")}

    def flipped(args):
        return tuple(x.flip(0) if torch.is_tensor(x) else x for x in args)
    runs = [(entry, a) for entry in pools
            for a in (pools[entry], flipped(pools[entry]))]
    pairs = [(runs[0], runs[1]), (runs[2], runs[3]), (runs[0], runs[2])]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for pair in pairs:
        torch.cuda.synchronize()
        got = []
        for stream, (entry, args) in zip(streams, pair):
            with torch.cuda.stream(stream):
                got.append(getattr(pcap, entry)(*args))
        torch.cuda.synchronize()
        for (entry, args), (v, hit) in zip(pair, got):
            rv, rhit = getattr(pcap, entry + "_reference")(*args)
            assert _same(v, rv)
            assert torch.equal(hit, rhit)


def test_update_wrappers_check(card):
    """The update kernels' wrappers raise on what their kernels do not
    take, before any launch."""
    from cnf2freq_tpu_torch.updates import capped as pcap
    from cnf2freq_tpu_torch.updates import relskew as prs
    z = torch.rand((3, 4), dtype=torch.float64, device=card)
    brk = torch.zeros((3, 4), dtype=torch.bool, device=card)
    row = torch.rand(3, dtype=torch.float64, device=card)
    before = (pcap.capped_haplo.launches, pcap.capped_infprob.launches,
              prs.relskew_ratio.launches)
    with pytest.raises(TypeError):
        pcap.capped_haplo(z, z.float(), z, z, z, row, row, brk, 0.1, 0.013)
    with pytest.raises(ValueError):
        pcap.capped_haplo(z, z, z, z, z, row[:2], row, brk, 0.1, 0.013)
    a = torch.rand((3, 4, 2, 2), dtype=torch.float64, device=card)
    with pytest.raises(ValueError):
        pcap.capped_infprob(a, a, a, a, row, 0.1, 0.013)
    with pytest.raises(ValueError):
        prs.relskew_ratio(z.t(), z.t())
    with pytest.raises(TypeError):
        prs.relskew_ratio(z, z.float())
    assert before == (pcap.capped_haplo.launches,
                      pcap.capped_infprob.launches,
                      prs.relskew_ratio.launches)


COHERENCE_CASES = ["sweeps", "edge_batch", "edges", "flat_unit",
                   "boundary_span", "M2", "M1", "ragged"]


def _coherence_inputs(card, dtype, case):
    """(fbres, blocks, family batch, cfg, lam) of the coherence kernel on
    the card: the classic sweeps of the _inputs cohort (or of _edge_batch,
    or with unit 3 untyped), edited or cut to the case."""
    if case == "edge_batch":
        fb, dists, cfg, params = _edge_batch()
    else:
        _, fb, dists, cfg, params = cohort(B=37, M=11, seed=9,
                                           with_vacant=True)
    if case == "flat_unit":
        fb = flat_unit(fb, 3)
    fbt = torch_batch(fb).to(card, dtype)
    d = torch.as_tensor(dists, dtype=dtype, device=card)
    lam = transition_eigenvalues(cfg, interval_recomb(cfg, params, d))
    blocks = build_blocks(fbt, cfg, dtype=dtype)
    fbres = FBResult(*pfb.fb_sweeps(assemble_e_all(blocks, cfg), lam))
    if case == "edges":
        fbres = coherence_edge_sweeps(fbres)
    # ragged: 39 units x 6 markers, 234 pairs (195 with a chain), neither
    # a multiple of the kernel's 4 pairs a block
    cut = {"boundary_span": slice(4, 6), "M2": slice(0, 2),
           "M1": slice(0, 1), "ragged": slice(0, 6)}.get(case)
    if cut is not None:
        if case == "boundary_span":
            fbres = boundary_span(fbres, 4)
        else:
            fbres = FBResult(*(None if x is None else x[:, cut]
                               for x in fbres))
        fbt = ps.marker_slice(fbt, cut)
        lam = lam[cut.start:cut.stop - 1]
        blocks = build_blocks(fbt, cfg, dtype=dtype)
    return fbres, blocks, fbt, cfg, lam


def _promoted(fbres, blocks, lam):
    return (FBResult(*(None if x is None else x.double() for x in fbres)),
            blocks._replace(froot=blocks.froot.double(),
                            pb=tuple(x.double() for x in blocks.pb)),
            lam.double())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", COHERENCE_CASES)
def test_coherence_matches_plain(card, case, dtype):
    fbres, blocks, fbt, cfg, lam = _coherence_inputs(card, dtype, case)
    before = pcoh.coherence.launches
    got = probes.phase_coherence(fbres, blocks, fbt, cfg, lam)
    assert pcoh.coherence.launches == before + 1
    ref = probes.phase_coherence_reference(fbres, blocks, fbt, cfg, lam)
    assert got.shape == ref.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert (got[:, -1] == 0.5).all()
    if case == "edges":
        assert (got[1, 5] == 0.5).all() and (got[2, 6] == 0.5).all()
    if dtype == torch.float64:
        _close([got], [ref], dtype)
        return
    f64, b64, l64 = _promoted(fbres, blocks, lam)
    ref64 = probes.phase_coherence_reference(f64, b64, fbt, cfg, l64)

    def worst(x):
        return float(((x.double() - ref64).abs() /
                      (TOL[dtype]["atol"] + TOL[dtype]["rtol"] *
                       ref64.abs())).max())
    assert worst(got) <= 2.0 * max(worst(ref), 1.0)


def test_coherence_wrapper_refuses_on_card(card):
    """A wrong shape or type on the card raises before any launch."""
    fbres, blocks, fbt, cfg, lam = _coherence_inputs(card, torch.float64,
                                                     "sweeps")
    args = (fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, lam,
            blocks.froot, blocks.pb[0], blocks.pb[1], fbt.flag2ignore, cfg)
    before = pcoh.coherence.launches
    with pytest.raises(ValueError):
        pcoh.coherence(*args[:4], lam[1:], *args[5:])
    with pytest.raises(TypeError):
        pcoh.coherence(args[0], args[1].float(), *args[2:])
    with pytest.raises(ValueError):
        pcoh.coherence(*args[:4], lam.cpu(), *args[5:])
    assert pcoh.coherence.launches == before


# the classic scan's [B, M, NS, S] entries of csrc/emission.cu and
# csrc/turn.cu against their plain twins (build_blocks + assemble_e_all,
# turn_weights_fast_reference)
EMISSION_BMNS_CASES = ["cohort", "edge_batch", "all_attop", "M1",
                       "flat_unit", "no_e"]


def _bmns_batch(card, dtype, case):
    """A family batch on the card: the _inputs cohort (407 pairs, a ragged
    last block of 32), with unit 3 untyped, or the edited batch (at one
    marker, or with every focal a recursion top)."""
    if case in ("edge_batch", "all_attop", "M1"):
        fb, _, cfg, _ = _edge_batch(M=1 if case == "M1" else 11)
        if case == "all_attop":
            fb.attop = fb.attop.copy()
            fb.attop[:, 0] = True
    else:
        _, fb, _, cfg, _ = cohort(B=37, M=11, seed=9, with_vacant=True)
        if case == "flat_unit":
            fb = flat_unit(fb, 3)
    return torch_batch(fb).to(card, dtype), cfg


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", EMISSION_BMNS_CASES)
def test_emission_bmns_matches_plain(card, case, dtype):
    fbt, cfg = _bmns_batch(card, dtype, case)
    before = ps.emission_bmns.launches
    blocks, e = scan_blocks(fbt, cfg, dtype, with_e=case != "no_e")
    assert ps.emission_bmns.launches == before + 1
    ref = build_blocks(fbt, cfg, dtype=dtype)
    got = [blocks.froot, blocks.top, *blocks.pb]
    want = [ref.froot, ref.top, *ref.pb]
    if case == "no_e":
        assert e is None
    else:
        got.append(e)
        want.append(assemble_e_all(ref, cfg))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert bool(torch.isfinite(g).all())
    _close(got, want, dtype)
    assert torch.equal(blocks.focal_attop, fbt.attop[:, 0])


TURN_BMNS_CASES = ["sweeps", "edges", "M1", "flat_unit"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", TURN_BMNS_CASES)
def test_turn_bmns_matches_plain(card, case, dtype):
    """On the classic sweeps of the _inputs cohort (or with unit 3
    untyped), at their edges (turn_edge_sweeps: shift 0 alone, D exactly 0
    or negative; those units' weights exactly the twin's) and at one
    marker; compared above the cut with the v2 entry's slack."""
    _, fb, dists, cfg, params = cohort(B=37, M=11, seed=9, with_vacant=True)
    if case == "flat_unit":
        fb = flat_unit(fb, 3)
    fbt = torch_batch(fb).to(card, dtype)
    d = torch.as_tensor(dists, dtype=dtype, device=card)
    lam = transition_eigenvalues(cfg, interval_recomb(cfg, params, d))
    fbres = FBResult(*pfb.fb_sweeps(
        assemble_e_all(build_blocks(fbt, cfg, dtype=dtype), cfg), lam))
    if case == "edges":
        fbres, fbt = turn_edge_sweeps(fbres, fbt)
    if case == "M1":
        fbres = FBResult(*(x[:, :1].contiguous() for x in fbres))
    before = ps.turn_weights_bmns.launches
    got = probes.turn_weights_fast(fbres, fbt, cfg)
    assert ps.turn_weights_bmns.launches == before + 1
    ref = probes.turn_weights_fast_reference(fbres, fbt, cfg)
    assert got.shape == ref.shape and got.dtype == dtype
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if case == "edges":
        np.testing.assert_array_equal(got[[0, 2, 3]], ref[[0, 2, 3]])
        assert (ref[0] == -2e15).all()
    cut, slack = TURN[dtype]["cut"], TURN[dtype]["slack"]
    keep = ref > -cut
    assert (got[~keep] <= -cut + 1.0).all()
    np.testing.assert_allclose(got[keep], ref[keep], rtol=TOL[dtype]["rtol"],
                               atol=TOL[dtype]["atol"] + slack)


def test_bmns_wrappers_refuse_on_card(card):
    """A wrong shape, type or device on the card raises before any
    launch."""
    fbt, cfg = _bmns_batch(card, torch.float64, "cohort")
    B, M = fbt.md.shape[0], fbt.md.shape[2]
    before = (ps.emission_bmns.launches, ps.turn_weights_bmns.launches)
    with pytest.raises(TypeError):
        ps.emission_bmns(fbt, cfg, torch.float32)
    with pytest.raises(ValueError):
        ps.emission_bmns(dataclasses.replace(fbt, hw=fbt.hw[:, :6]), cfg,
                         torch.float64)
    with pytest.raises(ValueError):
        ps.emission_bmns(dataclasses.replace(fbt, ms=fbt.ms.cpu()), cfg,
                         torch.float64)
    x = torch.zeros((B, M, 8, 64), dtype=torch.float64, device=card)
    f = torch.zeros((B, M, 8), dtype=torch.float64, device=card)
    sh, desc = fbt.shiftignore, fbt.descendants
    with pytest.raises(ValueError):
        ps.turn_weights_bmns(x, x[..., :32], f, f, sh, desc, cfg)
    with pytest.raises(TypeError):
        ps.turn_weights_bmns(x, x.float(), f, f, sh, desc, cfg)
    with pytest.raises(ValueError):
        ps.turn_weights_bmns(x, x, f.cpu(), f, sh, desc, cfg)
    assert before == (ps.emission_bmns.launches,
                      ps.turn_weights_bmns.launches)
