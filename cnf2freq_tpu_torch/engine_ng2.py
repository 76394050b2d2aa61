"""Dedicated numgen==2 (4-state) engine: the QTLMAS15 shape
(settings.h:76-91: NUMGEN=2, NUMTYPES=4, NUMPATHS=8, NUMSHIFTS=2 with
haplotyping).

Port of ``cnf2freq_tpu/engine_ng2.py``.  The emission blocks come from
the numgen==3 factored builders (``hmm/emission.py``) applied to a 7-slot
embedding of the 3-slot family and reduced to per-parent leaf tensors
[b, m, r0, p(2), rp(2)]; the sweeps, posteriors and turn weights run on
[B, M, NS=2, S=4] tensors through the generic machinery (the sweeps in
``ops.fb.fb_sweeps``: csrc/fb_small.cu on the card); the update
statistics are the three-slot specialisations of the probe contractions
(focal phase bit r0^s0; parent k phase bit rp_k^g_k, cnF2freq.cpp:321-329).
The contractions stay ``torch.einsum``: the JAX package runs them as XLA
programs, not Pallas kernels.

Scope: haplotyping configs.  The no-haplotyping two-generation block
walks one pedigree level deeper (``engine_nohaplo.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import ZP_NONE, ModelConfig, RuntimeParams
from .engine import ScanResult
from .hmm.emission import _collapse, _match_raw, root_block, slot_data
from .hmm.family import FamilyBatch
from .hmm.forward_backward import (FBResult, combined_loglik,
                                   forward_backward)
from .hmm.probes import (pair_coherence_from_ej, posterior_weight,
                         turn_weights_fast_reference)
from .hmm.transition import interval_recomb, transition_eigenvalues
from .utils.transfer import constant

# static indicator tables ----------------------------------------------------
_J = np.arange(2)
# focal phase bit: r0 ^ s0
_IND_FOCAL = ((np.arange(2)[:, None, None] ^ np.arange(2)[None, :, None])
              == _J[None, None, :])
# parent phase bit: rp ^ g_k (no shift at two-generation parents)
_IND_PAR = ((np.arange(2)[:, None, None] ^ np.arange(2)[None, :, None])
            == _J[None, None, :])          # [g, rp, j]


def ng3_equiv(cfg: ModelConfig) -> ModelConfig:
    """The numgen==3 config whose emission builders evaluate the embedded
    two-generation family."""
    return ModelConfig(numgen=3, haplotyping=cfg.haplotyping,
                       selfing=False, relskews=cfg.relskews,
                       relskewstates=False, do_infprobs=cfg.do_infprobs,
                       correction_inference=cfg.correction_inference)


def embed7(fb: FamilyBatch) -> FamilyBatch:
    """7-slot view of a 3-slot numgen==2 batch: vacant grandparent slots,
    parents as recursion tops, flag2/shift masks remapped to the
    numgen==3 bit layout (parent0 bit 1 -> 1, parent1 bit 2 -> 4; vacant
    grandparent path bits pinned; parent shift bits disabled)."""
    def put(x, fill=0):
        z = torch.full_like(x[:, 0:1], fill)
        return torch.cat([x[:, 0:1], x[:, 1:2], z, z, x[:, 2:3], z, z],
                         dim=1)

    f2 = fb.flag2ignore
    f2ig7 = ((f2 & 1) | ((f2 >> 1) & 1) << 1 | ((f2 >> 2) & 1) << 4
             | 0b1101100)
    shig7 = fb.shiftignore | 0b110
    # parents are recursion tops in a two-generation unit
    attop3 = torch.stack([fb.attop[:, 0], torch.ones_like(fb.attop[:, 1]),
                          torch.ones_like(fb.attop[:, 2])], dim=1)
    dup7 = None
    if fb.dup_flip is not None:
        z = torch.zeros_like(fb.dup_flip[:, :, 0:1])
        dup7 = torch.cat([fb.dup_flip[:, :, 0:1], fb.dup_flip[:, :, 1:2], z,
                          z, fb.dup_flip[:, :, 2:3], z, z], dim=2)
    empty7 = None if fb.emptyslot is None else put(fb.emptyslot, False)
    return dataclasses.replace(
        fb, md=put(fb.md), ms=put(fb.ms), hw=put(fb.hw, fill=0.5),
        exists=put(fb.exists, False), attop=put(attop3, False),
        flag2ignore=f2ig7, shiftignore=shig7, slot_ind=put(fb.slot_ind),
        emptyslot=empty7, dup_flip=dup7)


def _leaf_block(par, v, sv, ci: bool, haplotyping: bool, dtype):
    """[..., r0(2), p0(2), rp(2)] leaf term of a two-generation parent:
    matched value with the second channel absorbed (attopnow at
    genwidth 1, cnF2freq.cpp:1095, 1213-1217) times the phase factor
    rp ^ p0 (parents carry no shift bit, upflagit cnF2freq.cpp:321-329);
    1 + sv with the path bit canonically pinned when vacant."""
    dev = par.hw.device

    def ex3(x):
        return x.reshape(x.shape + (1, 1, 1))

    def pick3(pair, idx):
        return torch.where(idx == 1, ex3(pair[..., 1]), ex3(pair[..., 0]))

    R0 = torch.arange(2, device=dev).reshape(2, 1, 1)
    P0 = torch.arange(2, device=dev).reshape(1, 2, 1)
    RP = torch.arange(2, device=dev).reshape(1, 1, 2)
    vb = pick3(v, R0)
    svb = pick3(sv, R0)
    bv, pre, _ = _match_raw(vb, svb, pick3(par.md, RP), pick3(par.ms, RP),
                            ZP_NONE)
    f2n = (RP ^ P0).to(dtype)
    collapse = ex3(_collapse(par.md, par.ms, ci))
    if haplotyping:
        w = (f2n - ex3(par.hw)).abs()
    else:
        w = torch.full_like(ex3(par.hw) + f2n, 0.5)
    ph = torch.where(collapse, f2n, w)
    exists = ex3(par.exists)
    term = torch.where(exists, (bv + pre) * ph, 1.0 + svb)
    return term * (exists | (RP == 0)).to(dtype)


def ng2_blocks(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
               dtype=torch.float64, inval=None, insv=None, side: int = 0):
    """(froot [b,m,r,t], P2 [k][b,m,r,p,rp], top, focal_attop): the
    4-state factored emission — the focal term from the shared
    root_block, each parent as a direct leaf tensor (the numgen==3 parent
    block with vacant grandparents: the fp axis collapses to p0, fpath to
    rp, sk pinned 0)."""
    rb = root_block(slot_data(fb, 0), zp=ZP_NONE, ci=ci,
                    haplotyping=cfg.haplotyping, inval=inval, insv=insv,
                    side=side, dtype=dtype)
    P2 = []
    for k in range(2):
        vk, svk = (rb.vA, rb.svA) if k == side else (rb.vB, rb.svB)
        P2.append(_leaf_block(slot_data(fb, 1 + k), vk, svk, ci,
                              cfg.haplotyping, dtype))
    return rb.froot, P2, rb.top, fb.attop[:, 0]


def _valid_paths2(flag2ignore: torch.Tensor, k: int) -> torch.Tensor:
    """[b, rp(2)] canonical-path mask for parent k's path bit."""
    f2 = (flag2ignore[:, None] >> (1 + k)) & 1
    return (torch.arange(2, device=flag2ignore.device)[None, :] & f2) == 0


def _masked_leaves(P2, fb: FamilyBatch, dtype):
    """Each parent's leaf with the canonical path mask applied."""
    return [P2[k] * _valid_paths2(fb.flag2ignore, k).to(dtype)[
        :, None, None, None, :] for k in range(2)]


def assemble_e_ng2(froot, P2, top, focal_attop, fb: FamilyBatch,
                   cfg: ModelConfig) -> torch.Tensor:
    """E[b, m, NS(2), S(4)] summed over paths; state g = g1*2 + g0."""
    ps = [x.sum(dim=-1) for x in _masked_leaves(P2, fb, froot.dtype)]
    e = torch.einsum("zmrt,zmra,zmrb->zmtba", froot, ps[0], ps[1])
    B, M = e.shape[:2]
    e = e.reshape(B, M, 2, 4)
    tops = top.sum(dim=-2)[:, :, :, None].expand(B, M, 2, 4)
    return torch.where(focal_attop[:, None, None, None], tops, e)


def _indicators(dtype, device):
    return (constant(_IND_FOCAL, device, dtype),
            constant(_IND_PAR, device, dtype))


def phase_resolved_emission_ng2(froot, P2, top, focal_attop,
                                fb: FamilyBatch, cfg: ModelConfig,
                                slot: int) -> torch.Tensor:
    """E_j[b, m, j(2), NS(2), S(4)]: emission restricted to the slot's
    phase-interpretation bit == j (focal: r0^s0; parent k: rp_k^g_k)."""
    PV = _masked_leaves(P2, fb, froot.dtype)
    ps = [x.sum(dim=-1) for x in PV]                      # [b,m,r,g]
    INDF, INDP = _indicators(froot.dtype, froot.device)
    if slot == 0:
        e = torch.einsum("zmrt,zmra,zmrb,rtj->zmjtba",
                         froot, ps[0], ps[1], INDF)
    elif slot == 1:
        ph = torch.einsum("zmrap,apj->zmraj", PV[0], INDP)
        e = torch.einsum("zmrt,zmraj,zmrb->zmjtba", froot, ph, ps[1])
    else:
        ph = torch.einsum("zmrbq,bqj->zmrbj", PV[1], INDP)
        e = torch.einsum("zmrt,zmrbj,zmra->zmjtba", froot, ph, ps[0])
    B, M = e.shape[:2]
    return e.reshape(B, M, 2, 2, 4)


def coherence_slot_ng2(fb: FamilyBatch, dists, fw_pre, bw, fw_pre_f, bw_f,
                       cfg: ModelConfig, params: RuntimeParams, slot: int,
                       ratemat=None) -> torch.Tensor:
    """Adjacent-phase coherence [B, M] for one slot of the 4-state
    engine (the last column is 0.5 padding)."""
    froot, P2, top, focal_attop = ng2_blocks(fb, cfg, dtype=fw_pre.dtype)
    lam = transition_eigenvalues(cfg, interval_recomb(
        cfg, params, dists, ratemat=ratemat)).to(fw_pre.dtype)
    e_j = phase_resolved_emission_ng2(froot, P2, top, focal_attop, fb, cfg,
                                      slot)
    fbres = FBResult(fw_pre=fw_pre, fw_post=fw_pre, bw=bw,
                     fw_pre_f=fw_pre_f, fw_post_f=fw_pre_f, bw_f=bw_f)
    return pair_coherence_from_ej(fbres, e_j, lam)


def haplo_update_mask_ng2(fb: FamilyBatch, cfg: ModelConfig,
                          ci: bool = False) -> torch.Tensor:
    """[b, m, 3] bool — visited, existing, not duplicate-allele
    collapsed (doupdatehaplo, cnF2freq.cpp:1224-1252)."""
    collapse = _collapse(fb.md, fb.ms, ci).transpose(1, 2)  # [b, m, slot]
    exists = fb.exists[:, None, :]
    par_vis = exists & ~fb.attop[:, 0][:, None, None]
    vis = torch.cat([torch.ones_like(par_vis[..., 0:1]), par_vis[..., 1:2],
                     par_vis[..., 2:3]], dim=-1)
    return vis & exists & ~collapse


def _side_folds(W, PV):
    """(T1 [b, m, r, g0, s0], T0 [b, m, r, g1, s0]): the posterior with
    parent 1 (T1) or parent 0 (T0) folded away."""
    B, M = W.shape[:2]
    Wr = W.reshape(B, M, 2, 2, 2)           # [b, m, s0, g1, g0]
    T1 = torch.einsum("zmrb,zmtba->zmrat", PV[1].sum(dim=-1), Wr)
    T0 = torch.einsum("zmra,zmtba->zmrbt", PV[0].sum(dim=-1), Wr)
    return Wr, T1, T0


def haplo_stats_ng2(W, froot, P2, fb, cfg):
    """[b, m, 3, 2] posterior phase-interpretation counts (updatehaplo,
    cnF2freq.cpp:1561-1575)."""
    PV = _masked_leaves(P2, fb, W.dtype)
    INDF, INDP = _indicators(W.dtype, W.device)
    _, T1, T0 = _side_folds(W, PV)
    # focal: [b, m, j]
    F = torch.einsum("zmra,zmrat->zmrt", PV[0].sum(dim=-1), T1)
    b_focal = torch.einsum("zmrt,zmrt,rtj->zmj", froot, F, INDF)
    # parent 0: fold froot + T1, project (g0, rp0) on the phase bit
    Y0 = torch.einsum("zmrt,zmrap,zmrat->zmap", froot, PV[0], T1)
    b_p0 = torch.einsum("zmap,apj->zmj", Y0, INDP)
    Y1 = torch.einsum("zmrt,zmrbq,zmrbt->zmbq", froot, PV[1], T0)
    b_p1 = torch.einsum("zmbq,bqj->zmj", Y1, INDP)
    return torch.stack([b_focal, b_p0, b_p1], dim=2)


def _share_blocks_ng2(fb, cfg, side, mv, ci, dtype):
    """U[b, m, r', p, rp, s0]: the traced side-branch of a GENOSPROBE
    with root value mv (sideval, cnF2freq.cpp:5517-5527).  Only the
    traced parent's leaf is built — the untraced branch cancels in the
    share ratio."""
    B, M = fb.md.shape[0], fb.md.shape[2]
    inval = torch.full((B, M), mv, dtype=torch.int32, device=fb.md.device)
    rb = root_block(slot_data(fb, 0), ci=ci, haplotyping=cfg.haplotyping,
                    inval=inval, side=side, dtype=dtype)
    leaf = _leaf_block(slot_data(fb, 1 + side), rb.vA, rb.svA, ci,
                       cfg.haplotyping, dtype)
    return rb.froot[:, :, :, None, None, :] * leaf[..., None]


def infprob_stats_ng2(W, froot, P2, fb, cfg, ci: bool = False):
    """(accum [b, m, 3, 2, 2], pair [b, m, 2, 2]): GENOS accumulator
    additions per slot/allele-slot/candidate plus the ordered-genotype
    posterior."""
    dtype = W.dtype
    B, M = W.shape[:2]
    PV = _masked_leaves(P2, fb, dtype)
    Wr, T1, T0 = _side_folds(W, PV)

    shares = {}
    for side in range(2):
        us = [_share_blocks_ng2(fb, cfg, side, mv, ci, dtype)
              for mv in (1, 2)]
        den = us[0] + us[1]
        ok = den > 0
        for i, mv in enumerate((1, 2)):
            sh = torch.where(ok, us[i] / torch.where(ok, den, 1.0), 0.0)
            if side == 1:
                sh = sh.flip(2)     # align r' = 1 - r to the r axis
            shares[(side, mv)] = sh

    RP = constant(np.eye(2), W.device, dtype)             # [rp, w]
    out = torch.zeros((B, M, 3, 2, 2), dtype=dtype, device=W.device)
    for mvi, mv in enumerate((1, 2)):
        X0 = torch.einsum("zmrt,zmrap,zmrapt,zmrat->zmrap",
                          froot, PV[0], shares[(0, mv)], T1)
        nf0 = X0.sum(dim=(-1, -2))                        # [z, m, r]
        out[:, :, 0, :, mvi] += nf0
        out[:, :, 1, :, mvi] += torch.einsum("zmrap,pw->zmw", X0, RP)

        X1 = torch.einsum("zmrt,zmrbq,zmrbqt,zmrbt->zmrbq",
                          froot, PV[1], shares[(1, mv)], T0)
        nf1 = X1.sum(dim=(-1, -2))
        out[:, :, 0, :, mvi] += nf1.flip(-1)
        out[:, :, 2, :, mvi] += torch.einsum("zmrbq,qw->zmw", X1, RP)

    # ordered-genotype posterior
    P0mv = torch.stack([torch.einsum("zmrap,zmrapt->zmrat", PV[0],
                                     shares[(0, mv)]) for mv in (1, 2)],
                       dim=2)
    P1mv = torch.stack([torch.einsum("zmrbq,zmrbqt->zmrbt", PV[1],
                                     shares[(1, mv)]) for mv in (1, 2)],
                       dim=2)
    T1mv = torch.einsum("zmjrbt,zmtba->zmjrat", P1mv, Wr)
    pair = torch.einsum("zmrt,zmirat,zmjrat->zmij", froot, P0mv, T1mv)
    return out, pair


def chromosome_scan_ng2(fb: FamilyBatch, dists: torch.Tensor,
                        cfg: ModelConfig, params: RuntimeParams,
                        with_infprobs: bool = True, ratemat=None,
                        with_coherence: bool = False) -> ScanResult:
    """One 4-state chromosome scan with the full ScanResult contract;
    ``with_coherence`` adds every slot's adjacent-phase coherence
    (``coherence_slot_ng2``'s math), else it is 0.5."""
    if not cfg.haplotyping:
        raise NotImplementedError(
            "the dedicated numgen==2 engine covers haplotyping configs; the "
            "no-haplotyping family runs engine_nohaplo")
    dtype = fb.ms.dtype
    B, M = fb.md.shape[0], fb.md.shape[2]
    froot, P2, top, focal_attop = ng2_blocks(fb, cfg, dtype=dtype)
    e = assemble_e_ng2(froot, P2, top, focal_attop, fb, cfg)
    fbres = forward_backward(e, dists, cfg, params, ratemat=ratemat)
    del e
    total = combined_loglik(fbres, fb.shiftignore)
    W = posterior_weight(fbres, total, fb.shiftignore)
    b12 = haplo_stats_ng2(W, froot, P2, fb, cfg)
    mask = haplo_update_mask_ng2(fb, cfg)
    if with_infprobs:
        inf, pair = infprob_stats_ng2(W, froot, P2, fb, cfg)
    else:
        inf = torch.zeros((B, M, 3, 2, 2), dtype=dtype, device=W.device)
        pair = torch.zeros((B, M, 2, 2), dtype=dtype, device=W.device)
    # the 4-state space's turn weights are plain on every device (no
    # kernel yet: ROADMAP Queue 2)
    turn_w = turn_weights_fast_reference(fbres, fb, cfg)
    if with_coherence:
        lam = transition_eigenvalues(cfg, interval_recomb(
            cfg, params, dists, ratemat=ratemat)).to(dtype)
        coh = torch.stack([pair_coherence_from_ej(
            fbres, phase_resolved_emission_ng2(froot, P2, top, focal_attop,
                                               fb, cfg, slot), lam)
            for slot in range(cfg.numslots)], dim=-1)
    else:
        coh = torch.full((B, M, cfg.numslots), 0.5, dtype=dtype,
                         device=W.device)
    return ScanResult(total=total, haplo_b12=b12, haplo_mask=mask,
                      inf_accum=inf, pair=pair, turn_weight=turn_w,
                      coherence=coh, fw_pre=fbres.fw_pre, bw=fbres.bw,
                      fw_pre_f=fbres.fw_pre_f, bw_f=fbres.bw_f)


def scan_merged_ng2(fb: FamilyBatch, dists: torch.Tensor, lut, ratemat,
                    cfg: ModelConfig, params: RuntimeParams,
                    num_individuals: int, with_coherence: bool = False,
                    group=None):
    """The numgen==2 form of ``engine.scan_merged``: (res, haplobase,
    haplocount, infacc), the merges summed over ``group``.  The JAX package (make_jitted_scan_merged_ng2)
    compiles the sweep/haplo part and the infprob part as two programs,
    only to keep XLA's compile time down, and leaves the merged scan's
    coherence at 0.5 (its Driver measures it per slot with
    coherence_slot_ng2); the port runs the same functions in order, with
    the same per-slot coherence inside the scan when ``with_coherence``."""
    from .parallel.collective import merge_haplos, merge_infprobs
    res = chromosome_scan_ng2(fb, dists, cfg, params, ratemat=ratemat,
                              with_coherence=with_coherence)
    hb, hc = merge_haplos(res.haplo_b12, res.haplo_mask, fb.hw, fb.slot_ind,
                          fb.descendants, lut, num_individuals, group=group)
    inf = merge_infprobs(res.inf_accum, fb.slot_ind, fb.descendants, lut,
                         num_individuals, group=group)
    return res, hb, hc, inf
