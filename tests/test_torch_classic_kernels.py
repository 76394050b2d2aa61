"""The classic scan's turn weights and emission blocks: the routed
functions against the JAX package, and the arithmetic of their kernels
(the [B, M, NS, S] entries of csrc/turn.cu and csrc/emission.cu)
emulated on the CPU.

On ``test_torch_coherence``'s cohort (5 units x 11 markers, float64,
randomised haploweights and error rates) the routed
``probes.turn_weights_fast`` and ``emission.scan_blocks`` run their plain
twins on the CPU, launch nothing, and equal the JAX ``turn_weights_fast``
and ``build_blocks`` + ``assemble_e_all`` at rtol 1e-10 (e, froot, top,
pb0, pb1 and w; turn weights where finite: impossible turns carry
MINFACTOR on both sides).  The JAX programs are that file's, so this one
compiles none of its own.

The kernels cannot run here, so their arithmetic is emulated and held to
the plain twins at rtol 1e-10 (float64; the twins' sums run in another
order):
  * csrc/emission.cu's [B, M, NS, S] entry (``_emission_kernel_form``):
    each pair's factor tables (parent factor A, parent phase PH, first and
    second grandparent factors F, S with the canonical-path weights folded
    in, e's path sums), every pathful block entry as the product
    A * PH * F * S, e from the path sums; on the cohort, on a batch edited
    so that every branch of the block math occurs (unknown values, the
    sex pseudo-allele, collapsed slots, zero error rates, vacant and
    founder parents, vacant grandparents, focal tops), with every focal a
    top, at one marker and with an untyped unit;
  * csrc/turn.cu's [B, M, NS, S] entry (``_turn_kernel_form``): the
    shift factors of lane k = lane & 7, register i of lane l holding
    x = i * 32 + l, the butterflies in the warp's order (strides 32..256
    in the lane, 1..16 across lanes), D / 512 read at the 128 offsets; on
    the cohort's sweeps, with shiftignore = 7 units, with D exactly 0 or
    negative at offsets (and at offset 0), at one marker and with an
    untyped unit.
The wrappers refuse a wrong type, shape or device (a CPU tensor included)
before any build or launch.
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_coherence import _case, _sweeps, jax_blocks
from torch_port_util import cohort, flat_unit, torch_batch, turn_edge_sweeps

from cnf2freq_tpu_torch import _build
from cnf2freq_tpu_torch.config import MINFACTOR, ModelConfig
from cnf2freq_tpu_torch.hmm import emission as pem
from cnf2freq_tpu_torch.hmm import probes
from cnf2freq_tpu_torch.hmm.forward_backward import FBResult
from cnf2freq_tpu_torch.ops import scan as ps

RTOL = 1e-10
FINITE = -1e14   # below: a MINFACTOR turn weight


def _launches():
    return ps.emission_bmns.launches, ps.turn_weights_bmns.launches


def _close_turns(got, ref):
    """Equal MINFACTOR masks, the finite weights at rtol 1e-10."""
    got, ref = np.asarray(got), np.asarray(ref)
    finite = ref > FINITE
    np.testing.assert_array_equal(finite, got > FINITE)
    np.testing.assert_array_equal(got[~finite], ref[~finite])
    np.testing.assert_allclose(got[finite], ref[finite], rtol=RTOL,
                               atol=1e-12)


def test_routed_matches_jax():
    (_, fb, _, cfg, _), _, sweeps, (ref_w, _, _) = _case()
    fbt = torch_batch(fb)
    before = _launches()
    blocks, e = pem.scan_blocks(fbt, cfg, torch.float64)
    w = probes.turn_weights_fast(sweeps, fbt, cfg)
    no_e, none = pem.scan_blocks(fbt, cfg, torch.float64, with_e=False)
    # CPU tensors launch nothing
    assert _launches() == before
    got = (blocks.froot, blocks.top, blocks.pb[0], blocks.pb[1], e)
    for name, g, r in zip(("froot", "top", "pb0", "pb1", "e"), got,
                          jax_blocks()):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=0, err_msg=name)
    _close_turns(w.numpy(), ref_w)
    assert none is None
    for a, b in zip((no_e.froot, no_e.top, *no_e.pb),
                    (blocks.froot, blocks.top, *blocks.pb)):
        assert torch.equal(a, b)
    # the twins are what the routers run on the CPU
    np.testing.assert_array_equal(
        w.numpy(), probes.turn_weights_fast_reference(sweeps, fbt,
                                                      cfg).numpy())


# ---------------------------------------------------------------------------
# csrc/emission.cu's [B, M, NS, S] entry, table for table
# ---------------------------------------------------------------------------
def _safe_div(a, b):
    ok = b > 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def _match_raw(v, sv, mdj, msj):
    """blocks.cuh's match_raw: (bv, pre, bound)."""
    unknown_v = v == 0
    bound = torch.where(unknown_v, mdj, v)
    miss = ~unknown_v & ~((mdj == 0) & (v != 9)) & (v != mdj)
    one = torch.ones_like(msj)
    effsecond = torch.where(unknown_v & (bound != 0), one, sv)
    effms = torch.where(mdj == 0, one, msj)
    pre_miss = torch.where((msj != 0) & (sv != 0), (1.0 - msj) * sv,
                           torch.zeros_like(msj))
    bv = torch.where(miss, msj, 1.0 - msj)
    pre = torch.where(miss, pre_miss, effms * effsecond)
    return bv, pre, bound


def _matched(v, sv, mdj, msj):
    bv, pre, _ = _match_raw(v, sv, mdj, msj)
    return bv + pre


class _Slot:
    """One slot of every pair: md, ms [B, M, 2], hw [B, M], exists and
    attop [B, 1]."""

    def __init__(self, fb, s):
        self.md, self.ms, self.hw = fb.md[:, s].long(), fb.ms[:, s], \
            fb.hw[:, s]
        self.exists, self.attop = fb.exists[:, s, None], fb.attop[:, s, None]

    def phase(self, x):
        collapse = (self.md[..., 0] == self.md[..., 1]) & \
            (self.ms[..., 0] == self.ms[..., 1])
        f = torch.full_like(self.hw, float(x))
        return torch.where(collapse, f, (f - self.hw).abs())


def _root(f):
    """cnf::root_block with focal value unknown and side 0, and the
    focal-as-top term: (froot, top, vA, svA, vB, svB) indexed [r0]
    ([r0][s0] for froot and top)."""
    zero_v, zero = torch.zeros_like(f.md[..., 0]), torch.zeros_like(f.hw)
    froot, top, vA, svA, vB, svB = [], [], [], [], [], []
    for r0 in range(2):
        ms_o, md_o = f.ms[..., 1 - r0], f.md[..., 1 - r0]
        bv_raw, pre, bound = _match_raw(zero_v, zero, f.md[..., r0],
                                        f.ms[..., r0])
        bv_abs = bv_raw + pre
        ms_nab = _safe_div(pre, bv_raw)
        bv = torch.where(f.attop, bv_abs, bv_raw)
        secfac = torch.where(ms_o != 0, 1.0 - ms_o, torch.ones_like(ms_o))
        froot.append([torch.where(f.attop, bv_abs * f.phase(r0 ^ s0),
                                  bv * f.phase(r0 ^ s0) * secfac)
                      for s0 in range(2)])
        top.append([bv_abs * f.phase(r0 ^ s0) for s0 in range(2)])
        vA.append(bound)
        svA.append(torch.where(f.attop, zero, ms_nab))
        vB.append(md_o)
        svB.append(torch.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o),
                               zero))
    return froot, top, vA, svA, vB, svB


def _side_tables(fb, k, v, sv):
    """pair_tables' factors of side k for one branch value (v, sv):
    A [rp], F and S [rp][j][rg][gb], PH [x]."""
    par = _Slot(fb, 1 + 3 * k)
    gps = [_Slot(fb, 2 + 3 * k + j) for j in range(2)]
    deep_ok = par.exists & ~par.attop
    one, zero = torch.ones_like(par.hw), torch.zeros_like(par.hw)
    A, F, S = [], [], []
    for rp in range(2):
        bv_raw, pre, bound = _match_raw(v, sv, par.md[..., rp],
                                        par.ms[..., rp])
        ms_nab = _safe_div(pre, bv_raw)
        md_o, ms_o = par.md[..., 1 - rp], par.ms[..., 1 - rp]
        sec_f = torch.where(ms_o != 0, 1.0 - ms_o, one)
        secsec = torch.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o), zero)
        A.append(torch.where(~par.exists, (1.0 + sv) if rp == 0 else zero,
                             torch.where(par.attop, bv_raw + pre,
                                         bv_raw * sec_f)))
        Fr, Sr = [], []
        for gp in gps:
            Fj, Sj = [], []
            for rg in range(2):
                live = gp.exists | (rg == 0)
                gf = torch.where(gp.exists, _matched(bound, ms_nab,
                                                     gp.md[..., rg],
                                                     gp.ms[..., rg]),
                                 1.0 + ms_nab)
                gs = torch.where(gp.exists, _matched(md_o, secsec,
                                                     gp.md[..., rg],
                                                     gp.ms[..., rg]),
                                 1.0 + secsec)
                shallow = one if rg == 0 else zero
                Fg, Sg = [], []
                for gb in range(2):
                    ph = torch.where(gp.exists, gp.phase(rg ^ gb), one)
                    Fg.append(torch.where(~deep_ok, shallow, torch.where(
                        live, gf * ph, zero)))
                    Sg.append(torch.where(~deep_ok, shallow, torch.where(
                        live, gs * ph, zero)))
                Fj.append(Fg)
                Sj.append(Sg)
            Fr.append(Fj)
            Sr.append(Sj)
        F.append(Fr)
        S.append(Sr)
    PH = [torch.where(par.exists, par.phase(x), one) for x in range(2)]
    return A, F, S, PH


def _emission_kernel_form(fb):
    """(froot, top, pb0, pb1, e) as the [B, M, NS, S] entry of
    csrc/emission.cu computes them: phase 1's tables per (side k, branch
    r0), then every output a product of table entries (phase 2)."""
    f = _Slot(fb, 0)
    froot, top, vA, svA, vB, svB = _root(f)
    tabs = [[_side_tables(fb, k, *((vA[r0], svA[r0]) if k == 0 else
                                   (vB[r0], svB[r0])))
             for r0 in range(2)] for k in range(2)]
    pbs = []
    for k in range(2):
        ent = []
        for y in range(256):
            r0, fp, fpath, sk = y >> 7, (y >> 4) & 7, (y >> 1) & 7, y & 1
            p0, gb0, gb1 = fp & 1, (fp >> 1) & 1, fp >> 2
            rp, rg0, rg1 = fpath & 1, (fpath >> 1) & 1, fpath >> 2
            A, F, S, PH = tabs[k][r0]
            g = F[rp][0][rg0][gb0] * S[rp][1][rg1][gb1] if p0 == 0 else \
                F[rp][1][rg1][gb1] * S[rp][0][rg0][gb0]
            ent.append(A[rp] * PH[rp ^ p0 ^ sk] * g)
        pbs.append(torch.stack(ent, -1).unflatten(-1, (2, 8, 8, 2)))
    # e's path sums [k][r0][fp][sk] (ones for a focal top) and root factor
    PS = [[[[None] * 2 for _ in range(8)] for _ in range(2)]
          for _ in range(2)]
    for k in range(2):
        for r0 in range(2):
            A, F, S, PH = tabs[k][r0]
            for fp in range(8):
                p0, gb0, gb1 = fp & 1, (fp >> 1) & 1, fp >> 2
                for sk in range(2):
                    acc = 0.0
                    for rp in range(2):
                        g = (F[rp][0][0][gb0] + F[rp][0][1][gb0]) * \
                            (S[rp][1][0][gb1] + S[rp][1][1][gb1]) \
                            if p0 == 0 else \
                            (F[rp][1][0][gb1] + F[rp][1][1][gb1]) * \
                            (S[rp][0][0][gb0] + S[rp][0][1][gb0])
                        acc = acc + A[rp] * PH[rp ^ p0 ^ sk] * g
                    PS[k][r0][fp][sk] = torch.where(
                        f.attop, torch.ones_like(acc), acc)
    EF = [[torch.where(f.attop, (froot[0][t_] + froot[1][t_]) if r0 == 0
                       else torch.zeros_like(f.hw), froot[r0][t_])
           for t_ in range(2)] for r0 in range(2)]
    e = []
    for x in range(512):
        t_, u, v = (x >> 6) & 1, (x >> 7) & 1, x >> 8
        a, b = x & 7, (x >> 3) & 7
        e.append(EF[0][t_] * PS[0][0][a][u] * PS[1][0][b][v] +
                 EF[1][t_] * PS[0][1][a][u] * PS[1][1][b][v])
    e = torch.stack(e, -1).unflatten(-1, (8, 64))

    def pairs(z):
        return torch.stack([torch.stack(r, -1) for r in z], -2)
    return pairs(froot), pairs(top), pbs[0], pbs[1], e


def _edge_batch(fb):
    """A copy of a numpy batch (>= 12 units, with F1 focals) edited so
    that every branch of the block math occurs."""
    rng = np.random.default_rng(5)
    md, ms = fb.md.copy(), fb.ms.copy()
    md = np.where(rng.uniform(size=md.shape) < 0.2, 0, md)
    nine = rng.uniform(size=(md.shape[0], 1, md.shape[2], 1)) < 0.3
    ms = np.where(nine & (md == 0), 0.2, ms)
    md = np.where(nine, np.where(md == 2, 9, np.maximum(md, 1)), md)
    col = rng.uniform(size=md.shape[:3]) < 0.2
    md[..., 1] = np.where(col, md[..., 0], md[..., 1])
    ms[..., 1] = np.where(col, ms[..., 0], ms[..., 1])
    ms = np.where(rng.uniform(size=ms.shape) < 0.15, 0.0, ms)
    ex, at = fb.exists.copy(), fb.attop.copy()
    for b in range(md.shape[0]):
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
    return dataclasses.replace(fb, md=md.astype(np.int32), ms=ms, exists=ex,
                               attop=at)


def _emission_case(case):
    if case == "cohort":
        return _case()[0][1]
    _, fb, _, _, _ = cohort(B=12, M=7, seed=5, with_vacant=True)
    if case == "flat_unit":
        return flat_unit(fb, 3)
    fb = _edge_batch(fb)
    if case == "all_tops":
        fb.attop = fb.attop.copy()
        fb.attop[:, 0] = True
    if case == "M1":
        fb = dataclasses.replace(fb, md=fb.md[:, :, :1], ms=fb.ms[:, :, :1],
                                 hw=fb.hw[:, :, :1])
    return fb


@pytest.mark.parametrize("case", ["cohort", "edges", "all_tops", "M1",
                                  "flat_unit"])
def test_emission_kernel_form(case):
    fbt = torch_batch(_emission_case(case))
    cfg = ModelConfig()
    blocks, e = pem.scan_blocks(fbt, cfg, torch.float64)
    got = _emission_kernel_form(fbt)
    ref = (blocks.froot, blocks.top, blocks.pb[0], blocks.pb[1], e)
    for name, g, r in zip(("froot", "top", "pb0", "pb1", "e"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL, atol=0,
                                   err_msg=name)
    if case == "edges":
        # the edits reach the branches: vacant-parent and founder-parent
        # blocks (their rg = 1 paths empty), and focal tops
        assert bool(fbt.attop[:, 0].any()) and bool((~fbt.exists).any())
        assert (blocks.pb[0][1, :, :, :, 1:] == 0).all()
    if case == "all_tops":
        tops = blocks.top.sum(dim=-2).repeat(1, 1, 4)
        assert torch.equal(e, tops[..., None].expand_as(e))


# ---------------------------------------------------------------------------
# csrc/turn.cu's [B, M, NS, S] entry, lane for lane
# ---------------------------------------------------------------------------
def _wht512_warp(v):
    """csrc/turn.cu's wht512 on [P, 16, 32] (register i, lane): strides
    32..256 inside the lane (i and i | H), then 1..16 across the lanes
    (the upper lane takes partner - own, the lower own + partner)."""
    v = v.clone()
    i = torch.arange(16)
    for h in (1, 2, 4, 8):
        lo = i[(i & h) == 0]
        a, b = v[:, lo], v[:, lo + h]
        v[:, lo], v[:, lo + h] = a + b, a - b
    lane = torch.arange(32)
    for bit in (1, 2, 4, 8, 16):
        v = torch.where((lane & bit) != 0, v[:, :, lane ^ bit] - v,
                        v + v[:, :, lane ^ bit])
    return v


def _turn_kernel_form(fbres, shiftignore, descendants, cfg):
    """w [B, M, 128] as the [B, M, NS, S] entry of csrc/turn.cu computes
    it, a warp a (unit, marker) pair."""
    B, M = fbres.fw_post.shape[:2]
    P = B * M
    ff, bf = fbres.fw_post_f.reshape(P, 8), fbres.bw_f.reshape(P, 8)
    sh = shiftignore.long().repeat_interleave(M)
    allowed = (torch.arange(8)[None] & sh[:, None]) == 0
    big = torch.full_like(ff, -1e38)
    ffm = torch.where(allowed, ff, big).max(-1, keepdim=True).values
    bfm = bf.max(-1, keepdim=True).values
    fe = torch.where(allowed, torch.exp(ff - ffm), torch.zeros_like(ff))
    be = torch.exp(bf - bfm)
    shift = torch.arange(16) >> 1               # register i's shift
    f = fbres.fw_post.reshape(P, 16, 32) * fe[:, shift, None]
    b = fbres.bw.reshape(P, 16, 32) * be[:, shift, None]
    D = (_wht512_warp(_wht512_warp(f) * _wht512_warp(b)) *
         (1.0 / 512.0)).reshape(P, 512)
    tiny = torch.finfo(D.dtype).tiny
    v = D[:, torch.as_tensor(ps.turn_offsets(cfg)).long()]
    v0 = D[:, :1]
    w = torch.where((v > 0) & (v0 > 0),
                    torch.log(torch.clamp(v, min=tiny)) -
                    torch.log(torch.clamp(v0, min=tiny)),
                    torch.full_like(v, MINFACTOR))
    d = descendants.to(D.dtype).repeat_interleave(M)[:, None]
    return (w * d).reshape(B, M, 128)


@pytest.mark.parametrize("case", ["sweeps", "edges", "M1", "flat_unit"])
def test_turn_kernel_form(case):
    (_, fb, dists, cfg, params), _, sweeps, _ = _case()
    if case == "flat_unit":
        fb = flat_unit(fb, 3)
        sweeps = _sweeps(fb, dists, cfg, params)
    fbt = torch_batch(fb)
    if case == "edges":
        sweeps, fbt = turn_edge_sweeps(sweeps, fbt)
    if case == "M1":
        sweeps = FBResult(*(x[:, :1].contiguous() for x in sweeps))
    ref = probes.turn_weights_fast(sweeps, fbt, cfg)
    got = _turn_kernel_form(sweeps, fbt.shiftignore, fbt.descendants, cfg)
    _close_turns(got.numpy(), ref.numpy())
    if case == "edges":
        assert (ref[0] == 2 * MINFACTOR).all()
        assert (ref[2] == 0).any() and (ref[2] == 2 * MINFACTOR).any()
        assert (ref[3] == 2 * MINFACTOR).any() and (ref[3] == 0).any()
    if case == "flat_unit":
        assert (ref[3] > FINITE).any()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _turn_args(B=3, M=4, **shapes):
    want = dict(fw_post=(B, M, 8, 64), bw=(B, M, 8, 64), fw_post_f=(B, M, 8),
                bw_f=(B, M, 8))
    want.update(shapes)
    args = {k: _meta(v) for k, v in want.items()}
    args["shiftignore"] = _meta((B,), torch.int32)
    args["descendants"] = _meta((B,), torch.int32)
    return args


def _meta_batch(B=3, M=4, dtype=torch.float32, **over):
    fields = dict(md=_meta((B, 7, M, 2), torch.int32),
                  ms=_meta((B, 7, M, 2), dtype), hw=_meta((B, 7, M), dtype),
                  exists=_meta((B, 7), torch.bool),
                  attop=_meta((B, 7), torch.bool))
    fields.update(over)
    return type("Batch", (), fields)


TURN_BAD = {"bw_shape": dict(bw=(3, 4, 8, 32)),
            "factor_shape": dict(bw_f=(3, 4, 4))}
EMISSION_BAD = {"hw_shape": dict(hw=_meta((3, 7, 5))),
                "ms_dtype": dict(ms=_meta((3, 7, 4, 2), torch.float64)),
                "flags_shape": dict(attop=_meta((3, 6), torch.bool))}


@pytest.mark.parametrize("bad", ["bw_shape", "factor_shape", "bw_dtype",
                                 "not_cuda", "via_probes", "hw_shape",
                                 "ms_dtype", "flags_shape", "batch_on_cpu",
                                 "via_scan_blocks"])
def test_wrappers_refuse_before_launch(monkeypatch, bad):
    """Every refusal comes before a launch (and before the kernels are
    built); a tensor that is not on the card is refused, not routed to
    the plain twin."""
    def no_launch(*a, **k):
        raise AssertionError("launched")
    monkeypatch.setattr(_build, "launch", no_launch)
    monkeypatch.setattr(_build, "load_kernels", no_launch)
    cfg = ModelConfig()
    before = _launches()
    if bad in TURN_BAD or bad in ("bw_dtype", "not_cuda", "via_probes"):
        args = _turn_args(**TURN_BAD.get(bad, {}))
        if bad == "bw_dtype":
            args["bw"] = args["bw"].double()
        if bad == "not_cuda":
            args["fw_post_f"] = torch.zeros((3, 4, 8))
        if bad == "via_probes":
            fbres = FBResult(None, args["fw_post"], args["bw"], None,
                             args["fw_post_f"], args["bw_f"])
            fb = type("Batch", (), {"shiftignore": args["shiftignore"],
                                    "descendants": args["descendants"]})
            with pytest.raises(ValueError, match="CUDA"):
                probes.turn_weights_fast(fbres, fb, cfg)
        else:
            err, msg = ((TypeError, "dtype") if bad == "bw_dtype" else
                        (ValueError, "CUDA" if bad == "not_cuda" else
                         "shape"))
            with pytest.raises(err, match=msg):
                ps.turn_weights_bmns(**args, cfg=cfg)
    else:
        if bad == "batch_on_cpu":
            fb = _meta_batch(ms=torch.zeros((3, 7, 4, 2)),
                             hw=torch.zeros((3, 7, 4)))
            err, msg = ValueError, "CUDA"
        else:
            fb = _meta_batch(**EMISSION_BAD.get(bad, {}))
            err, msg = ((TypeError, "dtype") if bad == "ms_dtype" else
                        (ValueError, "CUDA" if bad == "via_scan_blocks" else
                         "shape"))
        if bad == "via_scan_blocks":
            with pytest.raises(err, match=msg):
                pem.scan_blocks(fb, cfg, torch.float32)
        else:
            with pytest.raises(err, match=msg):
                ps.emission_bmns(fb, cfg, torch.float32)
    assert _launches() == before
