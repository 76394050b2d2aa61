"""Posterior probes: update masks, turn weights, adjacent-marker phase
coherence, the line-origin reporter, recombination expectations, and the
extended state spaces' update statistics.

Port of the parts of ``cnf2freq_tpu/hmm/probes.py`` that the scans, the
line-origin reporter and the genetic-map re-estimation run.  The
standard space's update statistics come from ``ops.stats`` (kernel #3);
the extended spaces (``engine_ext.ext_statistics``) use the plain
contractions here (``haplo_stats``, ``infprob_stats``), which take
blocks with a root override or an interpretation pin.  These are
plain XLA in the JAX package, so they are plain PyTorch here: the
Walsh-Hadamard products are butterflies (``transition.fwht``), and each
multi-operand einsum of the coherence emissions is written as pairwise
contractions, so that no [B, M, ...] intermediate is larger than the
[B, M, NS, S] result.

Conventions: the state axis g decomposes into (fp1, fp0) and the shift
axis s into (s2, s1, s0); parent-block path bits are summed with the
canonical masks of flag2ignore.
"""

from __future__ import annotations

import numpy as np
import torch

from typing import NamedTuple

from ..config import MINFACTOR, ModelConfig
from ..ops.scan import turn_offsets
from ..utils.transfer import constant
from .emission import EmissionBlocks
from .family import FamilyBatch
from .forward_backward import FBResult
from .transition import apply_transition, fwht

# static indicator tables ----------------------------------------------------
_FP = np.arange(8)
_FPATH = np.arange(8)
_SK = np.arange(2)
_J = np.arange(2)

# parent phase bit: rp ^ p0 ^ sk  (rp = fpath bit0, p0 = fp bit0)
_IND_PARENT = (((_FPATH[None, :, None, None] & 1)
                ^ (_FP[:, None, None, None] & 1)
                ^ _SK[None, None, :, None]) == _J[None, None, None, :])
# grandparent j phase bit: rg_j ^ gb_j (fpath bit 1+j, fp bit 1+j)
_IND_GP = [((((_FPATH[None, :, None, None] >> (1 + j)) & 1)
             ^ ((_FP[:, None, None, None] >> (1 + j)) & 1))
            == _J[None, None, None, :]) & (_SK[None, None, :, None] >= 0)
           for j in range(2)]
# focal phase bit: r0 ^ s0
_R0 = np.arange(2)
_S0 = np.arange(2)
_IND_FOCAL = ((_R0[:, None, None] ^ _S0[None, :, None]) == _J[None, None, :])


def haplo_update_mask(fb: FamilyBatch, cfg: ModelConfig,
                      ci: bool = False) -> torch.Tensor:
    """[b, m, slot] bool: slots that receive haplo updates — visited,
    existing, and not in the duplicate-allele collapse branch."""
    collapse = fb.md[..., 0] == fb.md[..., 1]            # [b, slot, m]
    if not ci:
        collapse = collapse & (fb.ms[..., 0] == fb.ms[..., 1])
    collapse = collapse.transpose(1, 2)                  # [b, m, slot]
    if cfg.relskewstates:
        collapse = torch.cat([torch.zeros_like(collapse[..., :1]),
                              collapse[..., 1:]], dim=-1)
    exists = fb.exists[:, None, :]
    focal_attop = fb.attop[:, 0][:, None, None]
    par_vis = exists & ~focal_attop
    slot_vis = [torch.ones_like(par_vis[..., 0:1])]
    for k in range(2):
        ps = cfg.parent_slot(k)
        pv = par_vis[..., ps:ps + 1]
        slot_vis.append(pv)
        pat = fb.attop[:, ps][:, None, None]
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            slot_vis.append(pv & ~pat & exists[..., gs:gs + 1])
    vis = torch.cat(slot_vis, dim=-1)
    return vis & exists & ~collapse


def posterior_weight(fbres: FBResult, total: torch.Tensor,
                     shiftignore: torch.Tensor) -> torch.Tensor:
    """W[b, m, s, g]: the per-(shift, state) weight that multiplies E_f[g]
    to give the posterior of a (state, path, shift) probe."""
    NS = fbres.fw_pre_f.shape[-1]
    allowed = (torch.arange(NS, device=shiftignore.device)[None, :]
               & shiftignore[:, None]) == 0
    logw = fbres.fw_pre_f + fbres.bw_f - total[:, None, None]
    logw = torch.where(allowed[:, None, :], logw, MINFACTOR)
    return fbres.fw_pre * fbres.bw * torch.exp(logw)[..., None]


def _w_bits(W: torch.Tensor) -> torch.Tensor:
    """Reshape W[b, m, 8, 64] to bit axes [b, m, s2, s1, s0, fp1, fp0]."""
    B, M = W.shape[:2]
    return W.reshape(B, M, 2, 2, 2, 8, 8)


def _valid_paths(flag2ignore: torch.Tensor, k: int) -> torch.Tensor:
    """[b, fpath(8)] canonical-path mask for parent k's local path bits
    (flag2 bits 1+3k .. 3+3k)."""
    f2 = (flag2ignore[:, None] >> (1 + 3 * k)) & 7
    return (torch.arange(8, device=flag2ignore.device)[None, :] & f2) == 0


def probe_rule_factors(fb: FamilyBatch, cfg: ModelConfig, dtype,
                       variant: int = 0, tied_rule=True):
    """Multiplicative probe-survival factors of the ignoreflag2 rules 2-3
    (cnF2freq.cpp:3462-3496), for the statistics contractions.

    Rule 3 (shift-tied dedup): a member whose genotype is a duplicate pair
    with equal error values admits a probe only when its phase bit
    disagrees with its shift bit: focal r0 != s0; parent k
    (rp ^ p0) != s_{1+k}; grandparent phase bit == 1.  Rule 2
    (duplicate-member consistency): an individual in two slots needs equal
    phase bits there; the indicator is the average over the sign variants
    of ``fb.dup_flip`` of prod (-1)^(phase bit of a flipped slot), so
    callers average the statistics of variants 0..NV-1.

    tied_rule=False applies rule 2 only (the SELFING build disables rule
    3); tied_rule="nonfocal" keeps rule 3 for every member but the focal
    (the RELSKEWSTATES gate).

    Returns (F0 [b, m, r0, s0], [FPk [b, m, 1, fp, fpath, sk] for k])."""
    dev = fb.md.device
    md, ms = fb.md, fb.ms
    tied = fb.exists[:, :, None] & ~fb.emptyslot[:, :, None] & \
        (md[..., 0] == md[..., 1]) & (ms[..., 0] == ms[..., 1])
    tied = tied.transpose(1, 2)                        # [b, m, slot]
    if tied_rule == "nonfocal":
        tied = torch.cat([torch.zeros_like(tied[..., :1]), tied[..., 1:]],
                         dim=-1)
    elif not tied_rule:
        tied = torch.zeros_like(tied)

    def tab(x):
        return constant(x, dev, dtype)

    r0 = np.arange(2)[:, None]
    s0 = np.arange(2)[None, :]
    one = tab(1.0)
    F0 = torch.where(tied[:, :, 0, None, None], tab(r0 ^ s0), one)
    if fb.dup_flip is not None:
        F0 = F0 * torch.where(fb.dup_flip[:, variant, 0, None, None, None],
                              tab((-1.0) ** r0[:, 0])[None, None, :, None],
                              one)
    fp = np.arange(8)[:, None, None]
    fpath = np.arange(8)[None, :, None]
    sk = np.arange(2)[None, None, :]
    xp = (fp & 1) ^ (fpath & 1)                        # parent phase bit
    FPs = []
    for k in range(2):
        f = torch.ones((md.shape[0], md.shape[2], 8, 8, 2), dtype=dtype,
                       device=dev)
        ps = cfg.parent_slot(k)
        f = f * torch.where(tied[:, :, ps, None, None, None], tab(xp ^ sk),
                            one)
        if fb.dup_flip is not None:
            f = f * torch.where(
                fb.dup_flip[:, variant, ps, None, None, None, None],
                tab((-1.0) ** xp), one)
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            xg = ((fp >> (1 + j)) & 1) ^ ((fpath >> (1 + j)) & 1)
            f = f * torch.where(tied[:, :, gs, None, None, None], tab(xg),
                                one)
            if fb.dup_flip is not None:
                f = f * torch.where(
                    fb.dup_flip[:, variant, gs, None, None, None, None],
                    tab((-1.0) ** xg), one)
        FPs.append(f[:, :, None])                      # add r0 axis
    return F0, FPs


class HaploStats(NamedTuple):
    """b1/b2 accumulations per family slot plus the per-slot mask of the
    slots that receive updates."""

    b12: torch.Tensor    # [b, m, slot(7), 2]
    mask: torch.Tensor   # [b, m, slot(7)] bool


def side_collapse(PB, Wr):
    """(T1, T0): the posterior tensor with one parent branch absorbed —
    T1[z,m,r,a,u,t] folds branch 1 (and Wr) away for probes resolved on
    branch 0, T0[z,m,r,b,v,t] vice versa; Wr is read once for each."""
    T1 = torch.einsum("zmrbqv,zmvutba->zmraut", PB[1], Wr)
    T0 = torch.einsum("zmrapu,zmvutba->zmrbvt", PB[0], Wr)
    return T1, T0


def _masked_pb(blocks: EmissionBlocks, fb: FamilyBatch, dtype):
    V = [_valid_paths(fb.flag2ignore, k).to(dtype) for k in range(2)]
    return [blocks.pb[k] * V[k][:, None, None, None, :, None]
            for k in range(2)]


def haplo_stats(W: torch.Tensor, blocks: EmissionBlocks, fb: FamilyBatch,
                cfg: ModelConfig, ci: bool = False, t01=None, froot=None,
                PB=None) -> HaploStats:
    """Posterior-weighted phase-interpretation counts per slot (the sum
    of updatehaplo over every (g, flag2, shift) probe) from W
    [B, M, NS, S].  t01: a precomputed side_collapse; froot / PB:
    pre-decorated tensors (canonical-path masks and probe-rule factors
    applied)."""
    dtype, dev = W.dtype, W.device
    Wr = _w_bits(W)
    if froot is None:
        froot = blocks.froot
    if PB is None:
        PB = _masked_pb(blocks, fb, dtype)
    IND_P = constant(_IND_PARENT, dev, dtype)
    IND_G = [constant(x, dev, dtype) for x in _IND_GP]
    pbs = [PB[k].sum(dim=-2) for k in range(2)]
    if t01 is None:
        t01 = side_collapse(PB, Wr)
    T1, T0 = t01
    stats = []
    F = torch.einsum("zmrau,zmraut->zmrt", pbs[0], T1)
    stats.append(torch.einsum("zmrt,rtj->zmj", froot * F,
                              constant(_IND_FOCAL, dev, dtype)))
    for k in range(2):
        # one moment tensor per side; each slot stat is a projection of it
        if k == 0:
            Y = torch.einsum("zmrapu,zmraut,zmrt->zmapu", PB[0], T1, froot)
        else:
            Y = torch.einsum("zmrbqv,zmrbvt,zmrt->zmbqv", PB[1], T0, froot)
        stats.append(torch.einsum("zmfps,fpsj->zmj", Y, IND_P))
        for j in range(2):
            stats.append(torch.einsum("zmfps,fpsj->zmj", Y, IND_G[j]))
    b12 = torch.stack(stats, dim=2)                     # [b, m, 7, 2]
    return HaploStats(b12=b12, mask=haplo_update_mask(fb, cfg, ci))


class InfprobStats(NamedTuple):
    """Posterior-weighted candidate-allele statistics (GENOSPROBE sideval
    probes plus the GENOS accumulation along the traced branch)."""

    accum: torch.Tensor   # [b, m, slot(7), allele-slot(2), mv(2)]
    pair: torch.Tensor    # [b, m, 2, 2] joint P(slot0=mv0, slot1=mv1)


def _share_blocks(fb: FamilyBatch, cfg: ModelConfig, side: int, mv: int,
                  ci: bool, dtype, root_override=None) -> torch.Tensor:
    """U[b, m, r', fp, fpath, s0, sk] for the side branch of a GENOSPROBE
    with root value mv (factors common to both mv cancel in the share
    ratio).  root_override: the selfing HBD-collapsed focal pair."""
    from .emission import parent_block, root_block, slot_data
    focal = slot_data(fb, 0)
    B, M = fb.md.shape[0], fb.md.shape[2]
    inval = torch.full((B, M), mv, dtype=torch.int32, device=fb.md.device)
    rb = root_block(focal, ci=ci, haplotyping=cfg.haplotyping, inval=inval,
                    side=side, dtype=dtype, root_override=root_override,
                    no_root_collapse=cfg.relskewstates)
    par = slot_data(fb, cfg.parent_slot(side))
    gps = [slot_data(fb, cfg.grandparent_slot(side, j)) for j in range(2)]
    pbp = parent_block(par, gps[0], gps[1], rb.vA, rb.svA, ci=ci,
                       haplotyping=cfg.haplotyping, pathful=True)
    return rb.froot[:, :, :, None, None, :, None] * \
        pbp[:, :, :, :, :, None, :]


def infprob_shares(fb: FamilyBatch, cfg: ModelConfig, dtype,
                   ci: bool = False, root_override=None):
    """{(side, mv): share tensor [b, m, r, fp, fpath, s0, sk]} aligned to
    the standard probe's r axis: U_mv / sum_mv U_mv.  It depends on the
    blocks' root only, so a caller may compute it once for every
    probe-rule variant (``infprob_stats(shares=)``)."""
    shares = {}
    for side in range(2):
        us = [_share_blocks(fb, cfg, side, mv, ci, dtype,
                            root_override=root_override) for mv in (1, 2)]
        den = us[0] + us[1]
        ok = den > 0
        for i, mv in enumerate((1, 2)):
            sh = torch.where(ok, us[i] / torch.where(ok, den, 1.0), 0.0)
            if side == 1:
                sh = sh.flip(2)          # align r' = 1 - r to the r axis
            shares[(side, mv)] = sh
    return shares


def infprob_stats(W: torch.Tensor, blocks: EmissionBlocks, fb: FamilyBatch,
                  cfg: ModelConfig, ci: bool = False, t01=None, froot=None,
                  PB=None, root_override=None, drop_side1: bool = False,
                  shares=None) -> InfprobStats:
    """The GENOS accumulator additions per family slot, allele slot and
    candidate allele, plus the joint ordered-genotype posterior, from W
    [B, M, NS, S].  drop_side1: the side-1 probes are structurally dead
    (RELSKEWSTATES).  shares: a precomputed ``infprob_shares``."""
    dtype, dev = W.dtype, W.device
    Wr = _w_bits(W)
    if froot is None:
        froot = blocks.froot
    if PB is None:
        PB = _masked_pb(blocks, fb, dtype)
    if shares is None:
        shares = infprob_shares(fb, cfg, dtype, ci, root_override)

    bits = np.arange(8)
    w2 = np.arange(2)
    RP = constant(((bits[:, None] & 1) == w2[None, :]).astype(np.float64),
                  dev, dtype)                                  # [p, w]
    RGSEL = []
    for j in range(2):
        psel = ((bits[:, None, None] & 1) == j)
        tgt = (((bits[None, :, None] >> (1 + j)) & 1) == w2[None, None, :])
        RGSEL.append(constant((psel & tgt).astype(np.float64), dev, dtype))
    if t01 is None:
        t01 = side_collapse(PB, Wr)
    T1, T0 = t01

    out = {s: torch.zeros(W.shape[:2] + (2, 2), dtype=dtype, device=dev)
           for s in range(cfg.numslots)}
    for mvi, mv in enumerate((1, 2)):
        # side 0: the traced branch is parent 0
        X0 = torch.einsum("zmrapu,zmraptu->zmraptu", PB[0],
                          shares[(0, mv)])
        X0 = torch.einsum("zmraptu,zmraut,zmrt->zmrap", X0, T1, froot)
        nf0 = X0.sum(dim=(-1, -2))                        # [z, m, r]
        out[0][..., :, mvi] += nf0
        out[cfg.parent_slot(0)][..., :, mvi] += \
            torch.einsum("zmrap,pw->zmw", X0, RP)
        for j in range(2):
            out[cfg.grandparent_slot(0, j)][..., :, mvi] += \
                torch.einsum("zmrap,apw->zmw", X0, RGSEL[j])
        if drop_side1:
            continue
        X1 = torch.einsum("zmrbqv,zmrbqtv->zmrbqtv", PB[1],
                          shares[(1, mv)])
        X1 = torch.einsum("zmrbqtv,zmrbvt,zmrt->zmrbq", X1, T0, froot)
        nf1 = X1.sum(dim=(-1, -2))
        # the focal allele slot of side 1 is 1 - r
        out[0][..., :, mvi] += nf1.flip(-1)
        out[cfg.parent_slot(1)][..., :, mvi] += \
            torch.einsum("zmrbq,qw->zmw", X1, RP)
        for j in range(2):
            out[cfg.grandparent_slot(1, j)][..., :, mvi] += \
                torch.einsum("zmrbq,bqw->zmw", X1, RGSEL[j])
    accum = torch.stack([out[s] for s in range(cfg.numslots)], dim=2)

    # joint ordered-genotype posterior: both sides' shares on the same
    # posterior mass; branch 1 folds against Wr once
    P0 = torch.stack([torch.einsum("zmrapu,zmraptu->zmraut", PB[0],
                                   shares[(0, mv)]) for mv in (1, 2)], dim=2)
    P1 = torch.stack([torch.einsum("zmrbqv,zmrbqtv->zmrbvt", PB[1],
                                   shares[(1, mv)]) for mv in (1, 2)], dim=2)
    T1mv = torch.einsum("zmjrbvt,zmvutba->zmjraut", P1, Wr)
    pair = torch.einsum("zmiraut,zmjraut,zmrt->zmij", P0, T1mv, froot)
    return InfprobStats(accum=accum, pair=pair)


def turn_weights_fast(fbres: FBResult, fb: FamilyBatch,
                      cfg: ModelConfig) -> torch.Tensor:
    """Turn clause weights [B, M, T] from one joint Walsh-Hadamard
    xor-correlation over (shift, state):

        D[x] = sum_y fw'[y] * bw'[y ^ x],   x = shift*S + state,

    with fw' = fw_post * exp(fw_post_f - max), bw' = bw * exp(bw_f - max)
    (the per-(b, m) max factors cancel in the weight ratio against the
    no-flip turn); w[t] = (log D[x(t)] - log D[x(0)]) * descendants."""
    B, M, NS, S = fbres.fw_post.shape
    dtype = fbres.fw_post.dtype
    X = S * NS
    allowed = (torch.arange(NS, device=fb.shiftignore.device)[None, :]
               & fb.shiftignore[:, None]) == 0
    ff = torch.where(allowed[:, None, :], fbres.fw_post_f, -torch.inf)
    ffm = ff.max(dim=-1).values                            # [B, M]
    fexp = torch.where(allowed[:, None, :],
                       torch.exp(ff - ffm[..., None]), 0.0)
    bf = fbres.bw_f
    bexp = torch.exp(bf - bf.max(dim=-1).values[..., None])

    # joint index shift-major (s*S + g), matching the [.., NS, S] layout
    fwp = (fbres.fw_post * fexp[..., None]).reshape(B, M, X)
    bwp = (fbres.bw * bexp[..., None]).reshape(B, M, X)
    D = fwht(fwht(fwp, -1) * fwht(bwp, -1), -1) / X       # [B, M, X]

    idx = constant(turn_offsets(cfg), D.device, torch.long)
    vals = D[..., idx]                                     # [B, M, T]
    tiny = torch.finfo(dtype).tiny
    logv = torch.log(torch.clamp(vals, min=tiny))
    ok = vals > 0
    w = torch.where(ok & ok[..., 0:1], logv - logv[..., 0:1], MINFACTOR)
    return w * fb.descendants.to(dtype)[:, None, None]


# ---------------------------------------------------------------------------
# Adjacent-marker phase coherence
# ---------------------------------------------------------------------------
def _branch_emission(froot: torch.Tensor, left: torch.Tensor,
                     right: torch.Tensor) -> torch.Tensor:
    """e[b, m, v, u, t, b', a] = sum_r froot[.., r, t] * left[.., r, a, u]
    * right[.., r, b', v], reshaped to [B, M, NS, S] (shift (v, u, t),
    state (b', a)).  froot [B, M, 2, 2]; left/right [B, M, 2, 8, 2].
    Pairwise: the root folds into the left branch (64 values per pair),
    then one outer product per r adds into the 512-value result."""
    B, M = froot.shape[:2]
    e = None
    for r in range(2):
        fl = froot[:, :, r, :, None, None] * left[:, :, r, None]  # [t,a,u]
        fl = fl.permute(0, 1, 4, 2, 3)                       # [u, t, a]
        rt = right[:, :, r].transpose(2, 3)                  # [v, b']
        term = fl[:, :, None, :, :, None, :] * \
            rt[:, :, :, None, None, :, None]                 # [v,u,t,b',a]
        e = term if e is None else e + term
    return e.reshape(B, M, 8, 64)


def _path_summed(blocks: EmissionBlocks, fb: FamilyBatch, k: int):
    """Parent block k with the canonical path mask applied and the path
    axis summed: [B, M, r0, fp, sk]."""
    V = _valid_paths(fb.flag2ignore, k).to(blocks.froot.dtype)
    return (blocks.pb[k] * V[:, None, None, None, :, None]).sum(dim=-2)


def _phase_parity_emission(blocks: EmissionBlocks, fb: FamilyBatch,
                           cfg: ModelConfig, slot: int) -> torch.Tensor:
    """E_par[b, m, s, g]: the parity-signed emission e_{j=0} - e_{j=1} of
    the given slot's phase-interpretation bit, summed over all other path
    freedom."""
    dtype = blocks.froot.dtype
    dev = blocks.froot.device
    froot = blocks.froot
    if slot == 0:
        parf = constant(_IND_FOCAL[..., 0].astype(np.int8)
                        - _IND_FOCAL[..., 1].astype(np.int8), dev,
                        dtype)                                # [r, t]
        return _branch_emission(froot * parf, _path_summed(blocks, fb, 0),
                                _path_summed(blocks, fb, 1))
    k = 0 if slot < cfg.parent_slot(1) else 1
    local = slot - cfg.parent_slot(k)
    ind = _IND_PARENT if local == 0 else _IND_GP[local - 1]
    par = constant(ind[..., 0].astype(np.int8) - ind[..., 1].astype(np.int8),
                   dev, dtype)                                # [f, p, s]
    V = _valid_paths(fb.flag2ignore, k).to(dtype)
    vpar = V[:, None, None, None, :, None] * par              # [B,1,1,f,p,s]
    ph = (blocks.pb[k] * vpar).sum(dim=-2)                    # [B,M,r,f,s]
    if k == 0:
        return _branch_emission(froot, ph, _path_summed(blocks, fb, 1))
    return _branch_emission(froot, _path_summed(blocks, fb, 0), ph)


def _phase_resolved_emission(blocks: EmissionBlocks, fb: FamilyBatch,
                             cfg: ModelConfig, slot: int) -> torch.Tensor:
    """E_j[b, m, j(2), s, g]: the emission restricted to the slot's
    phase-interpretation bit == j, summed over all other path freedom."""
    dtype, dev = blocks.froot.dtype, blocks.froot.device
    froot = blocks.froot
    pbs = [_path_summed(blocks, fb, k) for k in range(2)]
    if slot == 0:
        fj = torch.einsum("zmrt,rtj->zmjrt", froot,
                          constant(_IND_FOCAL, dev, dtype))
        e = torch.stack([_branch_emission(fj[:, :, j], pbs[0], pbs[1])
                         for j in range(2)], dim=2)
    else:
        k = 0 if slot < cfg.parent_slot(1) else 1
        local = slot - cfg.parent_slot(k)
        ind = constant(_IND_PARENT if local == 0 else _IND_GP[local - 1],
                       dev, dtype)
        V = _valid_paths(fb.flag2ignore, k).to(dtype)
        ph = torch.einsum("zmrfps,zp,fpsj->zmjrfs", blocks.pb[k], V, ind)
        if k == 0:
            e = torch.stack([_branch_emission(froot, ph[:, :, j], pbs[1])
                             for j in range(2)], dim=2)
        else:
            e = torch.stack([_branch_emission(froot, pbs[0], ph[:, :, j])
                             for j in range(2)], dim=2)
    return e


def pair_chain(fbres: FBResult, e: torch.Tensor,
               lam: torch.Tensor) -> torch.Tensor:
    """<(fw_pre . e)[m], T_m ((e . bw)[m+1])> with shift-mode weights:
    the pairwise-joint contraction underlying coherence, for one signed
    emission tensor e [B, M, NS, S].  Returns [B, M-1]."""
    logw = fbres.fw_pre_f[:, :-1, :] + fbres.bw_f[:, 1:, :]
    logw = logw - logw.max(dim=-1, keepdim=True).values
    w = torch.exp(logw)                                  # [B, M-1, NS]
    x = fbres.fw_pre[:, :-1] * e[:, :-1]                 # [B,M-1,NS,S]
    xt = apply_transition(x, lam[:, None, :])
    y = e[:, 1:] * fbres.bw[:, 1:]
    return ((xt * y).sum(dim=-1) * w).sum(dim=-1)


def pair_coherence_from_ej(fbres: FBResult, e_j: torch.Tensor,
                           lam: torch.Tensor) -> torch.Tensor:
    """C[b, m] from a phase-resolved emission tensor e_j
    [B, M, j(2), NS, S]: the joint of the phase bit at markers m and m+1,
    same / total; the last column is 0.5 padding.  Generic over the state
    space (the 4-state engine's coherence)."""
    B = fbres.fw_pre.shape[0]
    logw = fbres.fw_pre_f[:, :-1, :] + fbres.bw_f[:, 1:, :]
    logw = logw - logw.max(dim=-1, keepdim=True).values
    w = torch.exp(logw)                                  # [B, M-1, NS]
    x = fbres.fw_pre[:, :-1, None] * e_j[:, :-1]         # [B,M-1,j,NS,S]
    xt = apply_transition(x, lam[:, None, None, :])
    y = e_j[:, 1:] * fbres.bw[:, 1:, None]               # [B,M-1,j',NS,S]
    jmat = torch.einsum("zmiag,zmjag,zma->zmij", xt, y, w)
    tot = jmat.sum(dim=(-1, -2))
    same = jmat[..., 0, 0] + jmat[..., 1, 1]
    ok = tot > 0
    c = torch.where(ok, same / torch.where(ok, tot, 1.0), 0.5)
    pad = torch.full((B, 1), 0.5, dtype=e_j.dtype, device=e_j.device)
    return torch.cat([c, pad], dim=1)


def pair_coherence_from_parity(fbres: FBResult, e_par: torch.Tensor,
                               lam: torch.Tensor,
                               tot: torch.Tensor) -> torch.Tensor:
    """C[b, m] from the parity-signed emission e_par and the shared pair
    total ``tot`` = pair_chain(e_all): with corr = same - diff and
    tot = same + diff, C = same / tot = (tot + corr) / (2 tot).  The last
    column is 0.5 padding."""
    B = e_par.shape[0]
    corr = pair_chain(fbres, e_par, lam)
    ok = tot > 0
    c = torch.where(ok, 0.5 + 0.5 * corr / torch.where(ok, tot, 1.0), 0.5)
    pad = torch.full((B, 1), 0.5, dtype=e_par.dtype, device=e_par.device)
    return torch.cat([c, pad], dim=1)


def phase_pair_total(fbres: FBResult, blocks: EmissionBlocks,
                     fb: FamilyBatch, cfg: ModelConfig,
                     lam: torch.Tensor) -> torch.Tensor:
    """The slot-independent pair total: pair_chain over the plain
    path-summed emission (what every slot's joint sums to)."""
    e = _branch_emission(blocks.froot, _path_summed(blocks, fb, 0),
                         _path_summed(blocks, fb, 1))
    return pair_chain(fbres, e, lam)


def phase_coherence_slot(fbres: FBResult, blocks: EmissionBlocks,
                         fb: FamilyBatch, cfg: ModelConfig,
                         lam: torch.Tensor, slot: int,
                         tot: torch.Tensor = None) -> torch.Tensor:
    """C[b, m]: posterior P(phase bit of `slot` equal at markers m, m+1)
    from the pairwise joint fw_pre[m] * E_par[m] * T_m * E_par[m+1] *
    bw[m+1] per shift mode; the last column is 0.5 padding.  ``tot``
    optionally supplies the shared phase_pair_total."""
    if tot is None:
        tot = phase_pair_total(fbres, blocks, fb, cfg, lam)
    e_par = _phase_parity_emission(blocks, fb, cfg, slot)
    return pair_coherence_from_parity(fbres, e_par, lam, tot)


def phase_coherence(fbres: FBResult, blocks: EmissionBlocks,
                    fb: FamilyBatch, cfg: ModelConfig,
                    lam: torch.Tensor) -> torch.Tensor:
    """All-slot coherence [b, m, slot] (shared pair total), one slot's
    temporaries live at a time."""
    tot = phase_pair_total(fbres, blocks, fb, cfg, lam)
    cols = [phase_coherence_slot(fbres, blocks, fb, cfg, lam, slot, tot=tot)
            for slot in range(cfg.numslots)]
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# Line-origin reporter
# ---------------------------------------------------------------------------
def line_origin_posterior(W: torch.Tensor, blocks: EmissionBlocks,
                          fb: FamilyBatch, cfg: ModelConfig) -> torch.Tensor:
    """P[b, m, c(3)]: posterior distribution of the line-origin class —
    how many of the focal's two strands trace to a founder allele '2'.

    The tensor form of the reference's zeropropagate gstr probe
    (trackpossible<false, true> at cnF2freq.cpp:5512; the counting hook
    at cnF2freq.cpp:1264-1266): under zero-propagation the inheritance
    path of every (state, path, shift) probe is deterministic, so the
    count is a pure function of the path bits and each branch's top
    slot — parent's grandparent ``p0`` read at interpretation ``rg``,
    the parent itself when it is a founder or its ancestor slot is
    vacant (the recursion's ``par is None`` stop), or the focal for a
    vacant first-branch parent."""
    if cfg.selfing or cfg.relskewstates:
        raise ValueError("line-origin reporter supports the standard "
                         "state space only")
    dtype, dev = W.dtype, W.device
    Wr = _w_bits(W)
    froot, pb = blocks.froot, blocks.pb
    V = [_valid_paths(fb.flag2ignore, k).to(dtype) for k in range(2)]
    PB = [pb[k] * V[k][:, None, None, None, :, None] for k in range(2)]

    idx = torch.arange(8, device=dev)
    p0 = idx & 1                              # gp fed by the bound allele
    rp = idx & 1                              # parent interpretation bit

    def pick_m(md2, bit):
        """md2 [B, M, 2] indexed by a [len]-bit tensor -> [B, M, len]."""
        return torch.where(bit[None, None, :] == 1, md2[:, :, 1:2],
                           md2[:, :, 0:1])

    sides = []
    for k in range(2):
        ps = cfg.parent_slot(k)
        par_rp2 = pick_m(fb.md[:, ps] == 2, rp)        # [B, M, fpath]
        gp2, gpex = [], []
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            rgj = (idx >> (1 + j)) & 1
            gp2.append(pick_m(fb.md[:, gs] == 2, rgj))  # [B, M, fpath]
            gpex.append(fb.exists[:, gs])
        gpj2 = torch.where(p0[None, None, :, None] == 1,
                           gp2[1][:, :, None, :], gp2[0][:, :, None, :])
        gpjex = torch.where(p0[None, :] == 1, gpex[1][:, None],
                            gpex[0][:, None])          # [B, fp]
        deep = torch.where(gpjex[:, None, :, None], gpj2,
                           par_rp2[:, :, None, :])     # [B, M, fp, fpath]
        par_at = fb.attop[:, ps][:, None, None, None]
        par_ex = fb.exists[:, ps][:, None, None, None, None]
        ind_fp = torch.where(par_at, par_rp2[:, :, None, :], deep)
        ind_fp = ind_fp[:, :, None].expand(-1, -1, 2, -1, -1)
        if k == blocks.side:
            # vacant first-branch parent: count at the focal, md[r0]
            vac = (fb.md[:, 0] == 2)[:, :, :, None, None]
            ind_k = torch.where(par_ex, ind_fp, vac)
        else:
            # the recursion never counts a vacant second-branch parent
            # (subtrack returns without the gstr hook)
            ind_k = ind_fp & par_ex
        sides.append(ind_k.to(dtype))                  # [B, M, r, fp, fpath]

    PBc = [(PB[k] * (1.0 - sides[k])[..., None], PB[k] * sides[k][..., None])
           for k in range(2)]
    T1c = [torch.einsum("zmrbqv,zmvutba->zmraut", PBc[1][c1], Wr)
           for c1 in range(2)]
    P = [[torch.einsum("zmrapu,zmraut,zmrt->zm", PBc[0][c0], T1c[c1], froot)
          for c1 in range(2)] for c0 in range(2)]
    out = torch.stack([P[0][0], P[0][1] + P[1][0], P[1][1]], dim=-1)

    # founder focal: the walk stops at the root; class = [md[r0] == 2]
    Wt = Wr.sum(dim=(2, 3, 5, 6))                      # [B, M, t]
    focal2 = (fb.md[:, 0] == 2).to(dtype)              # [B, M, r]
    pf1 = torch.einsum("zmrt,zmr,zmt->zm", blocks.top, focal2, Wt)
    pf0 = torch.einsum("zmrt,zmr,zmt->zm", blocks.top, 1.0 - focal2, Wt)
    pf = torch.stack([pf0, pf1, torch.zeros_like(pf0)], dim=-1)
    out = torch.where(blocks.focal_attop[:, None, None], pf, out)

    tot = out.sum(dim=-1, keepdim=True)
    return torch.where(tot > 0, out / torch.where(tot > 0, tot, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Recombination expectations (genetic-map re-estimation)
# ---------------------------------------------------------------------------
def recombination_expectations(fbres: FBResult, e_all: torch.Tensor,
                               cfg: ModelConfig,
                               lam: torch.Tensor) -> torch.Tensor:
    """P[b, m, t]: posterior probability that meiosis bit t recombined in
    interval (m, m+1).

    The reference estimates this with per-(state, state) double-locked
    probes (twicestop + calcdistancecolrowsums, cnF2freq.cpp:3618-3638,
    5586-5664; default-off).  The direct form is the pairwise state joint
    fw_post[m] * R * (E[m+1] . bw[m+1]), whose xor marginal comes out of
    one Walsh-Hadamard correlation per interval."""
    S = fbres.fw_post.shape[-1]
    dtype, dev = fbres.fw_post.dtype, fbres.fw_post.device
    x_ = fbres.fw_post[:, :-1]                          # [B, M-1, NS, S]
    y_ = e_all[:, 1:] * fbres.bw[:, 1:]
    # xor-correlation Z[x] = sum_g X[g] Y[g ^ x] = H(H(X) * H(Y)) / S
    z = fwht(fwht(x_, -1) * fwht(y_, -1), -1) / S
    # weight each shift mode by its posterior factor share
    logw = fbres.fw_post_f[:, :-1] + fbres.bw_f[:, 1:]
    logw = logw - logw.max(dim=-1, keepdim=True).values
    z = (z * torch.exp(logw)[..., None]).sum(dim=2)     # [B, M-1, S]
    p = torch.clamp(z, min=0.0) * lam_to_kernel(lam)     # [B, M-1, S]
    tot = p.sum(dim=-1, keepdim=True)
    p = torch.where(tot > 0, p / torch.where(tot > 0, tot, 1.0), 0.0)
    x = torch.arange(S, device=dev)
    bits = ((x[:, None] >> torch.arange(cfg.typebits, device=dev)[None, :])
            & 1).to(dtype)
    return torch.einsum("bmx,xt->bmt", p, bits)


def lam_to_kernel(lam: torch.Tensor) -> torch.Tensor:
    """Invert the WHT: kernel R[interval, xor] from eigenvalues."""
    return fwht(lam, -1) / lam.shape[-1]
