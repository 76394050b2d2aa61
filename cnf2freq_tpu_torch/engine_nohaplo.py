"""Dedicated no-haplotyping engine (the reference's "F2 with no
haplotyping" build, settings.h:60-73).

Port of ``cnf2freq_tpu/engine_nohaplo.py``.  The state space is NUMGEN=2
/ TYPEBITS=2: four states g = (g1<<1)|g0, one bit per parent selecting
which grandparental strand fed that parent's transmitted allele;
NUMSHIFTS=1, every production probe passes flag2=-1, and there are no
haplotype weights (a flat 0.5 per interpretation, cnF2freq.cpp:1242-1251).

The emission walk descends one level deeper than the haplotyping
two-generation build: ``attopnow`` is ``genwidth == 0`` without
HAPLOTYPING (cnF2freq.cpp:1120), so the analysis unit is the full 7-slot
family [focal, p0, gp00, gp01, p1, gp10, gp11], and each node contributes
its FIRST feasible interpretation only (cnF2freq.cpp:1166), tensorised as
``where(branch0 > 0, branch0, branch1)`` at every level.

Without HAPLOTYPING the reference performs no parameter updates
(cnF2freq.cpp:5554): an iteration is a posterior computation, and the
scan's update statistics and turn weights are structurally zero.  The
sweeps run in ``ops.fb.fb_sweeps`` (csrc/fb_small.cu on the card, NS=1).
"""

from __future__ import annotations

import torch

from .config import SEXMARKER, UNKNOWN, ModelConfig, RuntimeParams
from .engine import ScanResult
from .hmm.family import FamilyBatch
from .hmm.forward_backward import combined_loglik, forward_backward
from .hmm.probes import posterior_weight


def _match(v, sv, b, s, dtype):
    """markermiss(ZP_NONE) + the baseval/mainsecond split
    (cnF2freq.cpp:1195-1222).  v [B,M] int inflow (UNKNOWN allowed), sv
    [B,M] float secondary weight; (b, s) one stored channel.  Returns
    (bound value, baseval, mainsecond)."""
    unknown_in = v == UNKNOWN
    bound = torch.where(unknown_in, b, v)
    miss = (~unknown_in) & ~((b == UNKNOWN) & (v != SEXMARKER)) & (v != b)
    base_miss = s
    msec_miss = torch.where((s > 0) & (sv > 0), (1.0 - s) * sv, 0.0)
    eff2 = torch.where(unknown_in & (bound != UNKNOWN),
                       torch.ones_like(sv), sv)
    base_hit = 1.0 - s
    effms = torch.where(b == UNKNOWN, 1.0, s)
    msec_hit = effms * eff2
    base = torch.where(miss, base_miss, base_hit).to(dtype)
    msec = torch.where(miss, msec_miss, msec_hit).to(dtype)
    return bound, base, msec


def _collapse(md, ms, ci):
    """Duplicate-allele canonicalisation (cnF2freq.cpp:1235-1240)."""
    same = md[..., 0] == md[..., 1]
    return same if ci else same & (ms[..., 0] == ms[..., 1])


def _slot(fb: FamilyBatch, s: int):
    return fb.md[:, s], fb.ms[:, s], fb.exists[:, s]


def _first_feasible(b0, b1):
    return torch.where(b0 > 0, b0, b1)


def _secondary(ms, r, dtype):
    """(secfac, secsec) of the second channel 1 - r."""
    s2 = ms[..., 1 - r]
    secfac = torch.where(s2 > 0, 1.0 - s2, 1.0).to(dtype)
    secsec = torch.where(s2 > 0, s2 / torch.clamp(1.0 - s2, min=1e-30), 0.0)
    return secfac, secsec


def _carried(base, msec):
    return torch.where(base > 0, msec / torch.where(base > 0, base, 1.0),
                       0.0)


def _gp_eval(gp, v, sv, dtype):
    """genwidth-0 leaf: first-feasible interpretation, attop fold, the
    0.5 depth rule (cnF2freq.cpp:1166, 1213-1217, 1229-1233); a missing
    grandparent contributes 1 + secondval (cnF2freq.cpp:1044-1046)."""
    md, ms, exists = gp
    outs = []
    for fp in range(2):
        _, base, msec = _match(v, sv, md[..., fp], ms[..., fp], dtype)
        outs.append((base + msec) * 0.5)
    return torch.where(exists[:, None], _first_feasible(*outs), 1.0 + sv)


def _par_eval(par, gp0, gp1, v, sv, ci, dtype):
    """genwidth-1 node -> [B, M, 2] over the parent's state bit g: match
    each interpretation fp, weight by the duplicate collapse or the flat
    0.5 (no haploweights, cnF2freq.cpp:1242-1251), descend into BOTH
    grandparents (matched value to gp[g], second channel to gp[1-g],
    cnF2freq.cpp:1277-1336), first-feasible select over fp; a missing
    parent is 1 + sv."""
    md, ms, exists = par
    coll = _collapse(md, ms, ci)
    gps = (gp0, gp1)
    branches = []
    for fp in range(2):
        bound, base, msec = _match(v, sv, md[..., fp], ms[..., fp], dtype)
        msec2 = _carried(base, msec)
        secfac, secsec = _secondary(ms, fp, dtype)
        secmark = md[..., 1 - fp]
        e1 = [_gp_eval(g, bound, msec2, dtype) for g in gps]
        e2 = [_gp_eval(g, secmark, secsec, dtype) for g in gps]
        per_g = []
        for g in range(2):
            w = torch.where(coll, float(fp ^ g), 0.5).to(dtype)
            per_g.append(base * w * secfac * e1[g] * e2[1 - g])
        branches.append(torch.stack(per_g, dim=-1))
    return torch.where(exists[:, None, None], _first_feasible(*branches),
                       1.0 + sv[..., None])


def _by_state(x, k: int):
    """x [..., 2] over parent k's bit, spread over the states
    g = (g1 << 1) | g0: out[..., g] = x[..., bit k of g] (a view and a
    copy on the device, where an index list would be a host upload)."""
    shape = x.shape[:-1] + (2, 2)
    y = x[..., None, :] if k == 0 else x[..., :, None]
    return y.expand(shape).reshape(x.shape[:-1] + (4,))


def nohaplo_branches(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                     dtype=torch.float64, inval=None, side: int = 0):
    """Per-interpretation emission branches [B, M, r, 4] BEFORE the
    first-feasible select, plus the allowed r range.

    inval=None is the production probe (inmarkerval UnknownMarkerVal,
    flag2=-1); an integer inval with ``side`` builds the GENOSPROBE
    sideval chain (flag = g*2 + side, flag99 = -1 ^ side,
    cnF2freq.cpp:5557-5566) — -1^1 == -2 restricts the focal to
    interpretation 0 through the f2s/f2end decode
    (cnF2freq.cpp:1144-1149)."""
    md_f, ms_f = fb.md[:, 0], fb.ms[:, 0]
    B, M = md_f.shape[:2]
    pars = (_slot(fb, 1), _slot(fb, 4))
    gps = ((_slot(fb, 2), _slot(fb, 3)), (_slot(fb, 5), _slot(fb, 6)))
    coll_f = _collapse(md_f, ms_f, ci)
    v_in = torch.full((B, M), UNKNOWN if inval is None else inval,
                      dtype=md_f.dtype, device=md_f.device)
    r_range = (0,) if inval is not None and side == 1 else (0, 1)
    sv_in = torch.zeros((B, M), dtype=dtype, device=md_f.device)

    branches = []
    for r in r_range:
        bound, base, msec = _match(v_in, sv_in, md_f[..., r], ms_f[..., r],
                                   dtype)
        msec2 = _carried(base, msec)
        secfac, secsec = _secondary(ms_f, r, dtype)
        secmark = md_f[..., 1 - r]
        w = torch.where(coll_f, float(r ^ side), 0.5).to(dtype)
        p_first = _par_eval(pars[side], *gps[side], bound, msec2, ci, dtype)
        p_second = _par_eval(pars[1 - side], *gps[1 - side], secmark,
                             secsec, ci, dtype)
        sub1 = _by_state(p_first, side)            # [B, M, 4]
        sub2 = _by_state(p_second, 1 - side)
        branches.append((base * w * secfac)[..., None] * sub1 * sub2)
    return torch.stack(branches, dim=2), r_range


def nohaplo_emission(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                     dtype=torch.float64, inval=None,
                     side: int = 0) -> torch.Tensor:
    """E[B, M, NS=1, 4]: first-feasible select over the focal
    interpretation (cnF2freq.cpp:1166 with HAPLOTYPING=false)."""
    br, r_range = nohaplo_branches(fb, cfg, ci=ci, dtype=dtype, inval=inval,
                                   side=side)
    e = br[:, :, 0] if len(r_range) == 1 else \
        _first_feasible(br[:, :, 0], br[:, :, 1])
    return e[:, :, None, :]


def nohaplo_feasibility(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                        dtype=torch.float64) -> torch.Tensor:
    """ok[B, M, r]: is interpretation r feasible for the focal under any
    state (the fixparents okvals check: flag2 in {0, 1} pins r at the
    focal, cnF2freq.cpp:1409-1428)."""
    br, _ = nohaplo_branches(fb, cfg, ci=ci, dtype=dtype)
    return (br > 0).any(dim=-1)


def nohaplo_pair(fb: FamilyBatch, cfg: ModelConfig, W: torch.Tensor,
                 ci: bool = False, dtype=torch.float64) -> torch.Tensor:
    """Ordered-genotype posterior [B, M, 2, 2] via GENOSPROBE shares
    (sidevals, cnF2freq.cpp:5557-5566): share of allele mv on side i,
    contracted against the state posterior W [B, M, 1, 4]."""
    shares = {}
    for side in range(2):
        us = [nohaplo_emission(fb, cfg, ci=ci, dtype=dtype, inval=mv,
                               side=side)[:, :, 0] for mv in (1, 2)]
        den = us[0] + us[1]
        ok = den > 0
        for i, mv in enumerate((1, 2)):
            shares[(side, mv)] = torch.where(
                ok, us[i] / torch.where(ok, den, 1.0), 0.0)
    Wg = W[:, :, 0]                              # [B, M, 4]
    return torch.stack(
        [torch.stack([(Wg * shares[(0, i)] * shares[(1, j)]).sum(-1)
                      for j in (1, 2)], dim=-1) for i in (1, 2)], dim=-2)


def _posterior(fb: FamilyBatch, cfg: ModelConfig, params: RuntimeParams,
               dists, ratemat):
    """(e, total, state posterior W * E [B, M, 1, 4]) of one chunk."""
    e = nohaplo_emission(fb, cfg, ci=cfg.correction_inference,
                         dtype=fb.ms.dtype)
    fbres = forward_backward(e, dists, cfg, params, ratemat=ratemat)
    total = combined_loglik(fbres, fb.shiftignore)
    # the probe value exp(probe - factor) equals W[g] * E[g]
    post = posterior_weight(fbres, total, fb.shiftignore) * e
    return fbres, total, post


def chromosome_scan_nohaplo(fb: FamilyBatch, dists: torch.Tensor,
                            cfg: ModelConfig, params: RuntimeParams,
                            with_infprobs: bool = True, ratemat=None,
                            with_coherence: bool = False) -> ScanResult:
    """One 4-state no-haplotyping chromosome scan with the ScanResult
    contract: likelihoods and genotype shares; the update statistics are
    structurally zero (cnF2freq.cpp:5554) and the coherence neutral."""
    dtype = fb.ms.dtype
    dev = fb.ms.device
    B, M = fb.md.shape[0], fb.md.shape[2]
    fbres, total, post = _posterior(fb, cfg, params, dists, ratemat)
    if with_infprobs:
        pair = nohaplo_pair(fb, cfg, post, ci=cfg.correction_inference,
                            dtype=dtype)
    else:
        pair = torch.zeros((B, M, 2, 2), dtype=dtype, device=dev)
    ns = cfg.numslots
    return ScanResult(
        total=total,
        haplo_b12=torch.zeros((B, M, ns, 2), dtype=dtype, device=dev),
        haplo_mask=torch.zeros((B, M, ns), dtype=torch.bool, device=dev),
        inf_accum=torch.zeros((B, M, ns, 2, 2), dtype=dtype, device=dev),
        pair=pair,
        turn_weight=torch.zeros((B, M, cfg.numturns), dtype=dtype,
                                device=dev),
        coherence=torch.full((B, M, ns), 0.5, dtype=dtype, device=dev),
        fw_pre=fbres.fw_pre, bw=fbres.bw, fw_pre_f=fbres.fw_pre_f,
        bw_f=fbres.bw_f)


def scan_merged_nohaplo(fb: FamilyBatch, dists: torch.Tensor, lut, ratemat,
                        cfg: ModelConfig, params: RuntimeParams,
                        num_individuals: int, with_coherence: bool = False,
                        group=None):
    """The no-haplotyping form of ``engine.scan_merged``: the scan plus
    inert merge outputs (no update exists in this family), [NI, M]
    zeros as the JAX package's make_jitted_scan_merged_nohaplo returns
    (the same on every rank of ``group``, so nothing is summed)."""
    res = chromosome_scan_nohaplo(fb, dists, cfg, params, ratemat=ratemat)
    M = fb.md.shape[2]
    kw = dict(dtype=fb.ms.dtype, device=fb.ms.device)
    return (res, torch.zeros((num_individuals, M), **kw),
            torch.zeros((num_individuals, M), **kw),
            torch.zeros((num_individuals, M, 2, 2), **kw))


def nohaplo_line_origin(fb: FamilyBatch, cfg: ModelConfig,
                        Wg: torch.Tensor) -> torch.Tensor:
    """P[b, m, c(3)]: line-origin class posterior for the deep-walk
    no-haplotyping family — the zeropropagate gstr probe
    (cnF2freq.cpp:5512; counting hook cnF2freq.cpp:1264-1266) under
    ``attopnow == (genwidth == 0)``: counting happens at the grandparent
    leaves, at a parent whose indexed grandparent is vacant, or at the
    focal when its first-branch parent is vacant (a vacant second-branch
    parent contributes no count, cnF2freq.cpp:1044-1046).  Under
    zero-propagation each node's first-feasible interpretation reduces to
    its local feasibility: interpretation 0 wins whenever
    markersure[0] < 1.

    Wg: [B, M, 4] posterior state mass (posterior_weight * emission)."""
    md_f, ms_f = fb.md[:, 0], fb.ms[:, 0]

    def picked2(md, ms):
        """Is the first-feasible raw interpretation allele 2: [B, M]."""
        r = torch.where(ms[..., 0] < 1.0, 0, 1)
        return torch.gather(md, -1, r[..., None])[..., 0] == 2

    sides = []
    for k in range(2):
        ps = cfg.parent_slot(k)
        ex_p = fb.exists[:, ps]
        p_cnt = picked2(fb.md[:, ps], fb.ms[:, ps])
        per_bit = []
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            g_cnt = picked2(fb.md[:, gs], fb.ms[:, gs])
            per_bit.append(torch.where(fb.exists[:, gs][:, None], g_cnt,
                                       p_cnt))
        side_cnt = torch.stack(per_bit, dim=-1)            # [B, M, 2]
        if k == 0:
            # vacant first-branch parent: the focal itself counts
            focal_cnt = picked2(md_f, ms_f)
            side_cnt = torch.where(ex_p[:, None, None], side_cnt,
                                   focal_cnt[..., None])
        else:
            side_cnt = side_cnt & ex_p[:, None, None]
        sides.append(side_cnt)

    # state g = (g1 << 1) | g0: parent k's strand follows state bit k
    c = _by_state(sides[0], 0).long() + _by_state(sides[1], 1).long()
    classes = torch.nn.functional.one_hot(torch.clamp(c, max=2), 3).to(
        Wg.dtype)
    P = torch.einsum("bmg,bmgc->bmc", Wg, classes)
    tot = P.sum(dim=-1, keepdim=True)
    return torch.where(tot > 0, P / torch.where(tot > 0, tot, 1.0), 0.0)


def line_origin_nohaplo(fb: FamilyBatch, dists: torch.Tensor,
                        cfg: ModelConfig, params: RuntimeParams,
                        ratemat=None) -> torch.Tensor:
    """Line-origin class posteriors [B, M, 3] of one chunk on a fresh
    forward/backward (the deep-walk branch of the JAX package's
    make_jitted_line_origin)."""
    _, _, post = _posterior(fb, cfg, params, dists, ratemat)
    return nohaplo_line_origin(fb, cfg, post[:, :, 0])
