"""Extended-state engine: the chromosome scans of the SELFING and
RELSKEWSTATES model families.

Port of ``cnf2freq_tpu/engine_ext.py``.  The extension is a tensor axis
of size V (3 HBD statuses under SELFING, 2 coherence-bit values under
RELSKEWSTATES) beside the 64-state axis:

* the base-state transition is the Walsh-Hadamard xor convolution and
  the extension's a [V, V] coupling per unit and interval (selfprec, or
  the coherence bit's relscore), so the sweeps are one kernel
  (``ops.fb.fb_ext``: csrc/fb_ext.cu on the card, kernel #7, which
  replaces the JAX package's two XLA ``lax.scan``s);
* emissions per extension value reuse the factored blocks with the
  focal's root replaced (the selfing HBD-collapsed pair through
  ``root_override``) or pinned (the RELSKEWSTATES interpretation as a
  one-hot factor on the root block);
* every update statistic is the standard contraction per extension
  value and probe-rule variant, summed over the axis
  (``ext_statistics``): on the card one launch of kernel #13 (the
  ``cnf_stats_ext_*`` entry of csrc/stats.cu, ``ops.stats.stats_ext``),
  which rebuilds each value's blocks from the family batch and forms
  the posterior weights itself; on the CPU its plain twin
  ``ext_statistics_reference``, the contractions of ``hmm.probes``
  (``haplo_stats``, ``infprob_stats``) as the JAX package computes them
  with XLA;
* SELFING's per-slot coherence (``coherence_ext``): on the card one
  launch of kernel #14 (``cnf_coherence_ext_*`` in csrc/coherence.cu,
  ``ops.coherence.coherence_ext``) for all seven slots, on the CPU the
  plain ``coherence_slot_ext`` per slot.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import MINFACTOR, ModelConfig, RuntimeParams
from .hmm.emission import assemble_e_all, build_blocks
from .hmm.family import FamilyBatch
from .hmm.transition import (apply_transition, fwht, interval_recomb,
                             transition_eigenvalues)
from .ops.coherence import coherence_ext as coherence_ext_kernel
from .ops.coherence import coherence_ext_reference
from .ops.fb import emit_normalise_ext, fb_ext
from .ops.scan import turn_offsets
from .ops.stats import stats_ext
from .utils.transfer import constant


class ExtFBResult(NamedTuple):
    """Sweep stores over the extended (V, state) space; the normalisers
    are per shift mode (adjustprobs normalises the whole extended state
    vector jointly)."""

    fw_pre: torch.Tensor    # [B, M, V, NS, S]
    fw_post: torch.Tensor
    bw: torch.Tensor
    fw_pre_f: torch.Tensor  # [B, M, NS]
    fw_post_f: torch.Tensor
    bw_f: torch.Tensor

    @property
    def total_loglik(self) -> torch.Tensor:
        return self.fw_post_f[:, -1, :]


def _vcoupling(fb: FamilyBatch, cfg: ModelConfig, params: RuntimeParams,
               dists: torch.Tensor, dtype) -> torch.Tensor:
    """[B, I, V, V] extension-axis transition factors per marker interval
    (row = from, column = to): selfprec under SELFING, the coherence
    bit's relscore[vf ^ vt] = (relh, 1 - relh) at the interval's left
    marker under RELSKEWSTATES."""
    if cfg.selfing:
        from .models.selfing import selfprec_tensor
        return selfprec_tensor(fb.selfgen, dists, params.genrec[2], dtype)
    from .models.relskew_states import relstate_coupling
    return relstate_coupling(fb.relh[:, :-1], dtype)


def _prior(fb: FamilyBatch, cfg: ModelConfig, dtype) -> torch.Tensor:
    """[B, V] initial extended-state weight per state (uniform over shifts
    and base states): EVENGEN, with the selfing HBD split from
    selfingfactors."""
    B = fb.exists.shape[0]
    V = cfg.numselfstates * cfg.numrelstates
    base = torch.full((B, V), cfg.evengen, dtype=dtype,
                      device=fb.exists.device)
    if cfg.selfing:
        from .models.selfing import selfing_factors
        base = base * selfing_factors(fb.selfgen, dtype)
    return base


def ext_collapses(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False):
    """collapses[v] [B, M]: the focal's duplicate-allele collapse flags of
    each extension value (SELFING: the standard pair's, then forced on
    for the HBD-collapsed pairs; RELSKEWSTATES: none)."""
    md, ms = fb.md[:, 0], fb.ms[:, 0]
    collapse_std = md[..., 0] == md[..., 1]
    if not ci:
        collapse_std = collapse_std & (ms[..., 0] == ms[..., 1])
    if cfg.selfing:
        forced = torch.ones_like(collapse_std)
        return [collapse_std, forced, forced]
    # no root collapse under RELSKEWSTATES
    nc = torch.zeros_like(collapse_std)
    return [nc, nc]


def ext_block_list(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                   dtype=torch.float64):
    """Per-extension-value emission blocks.  Returns (blocks[v],
    collapses[v] [B, M] focal duplicate-allele collapse flags
    (``ext_collapses``), root_overrides[v])."""
    md, ms = fb.md[:, 0], fb.ms[:, 0]
    b0 = build_blocks(fb, cfg, ci=ci, dtype=dtype)
    if cfg.selfing:
        from .models.selfing import hbd_overrides
        ov1, ov2, alive = hbd_overrides(md, ms)
        alive = alive.to(dtype)[:, :, None, None]
        blocks, ovs = [b0], [None]
        for ov in (ov1, ov2):
            bv = build_blocks(fb, cfg, ci=ci, dtype=dtype, root_override=ov)
            # a heterozygous focal with a certain first allele kills the
            # HBD hypothesis outright
            blocks.append(bv._replace(froot=bv.froot * alive,
                                      top=bv.top * alive))
            ovs.append(ov)
    else:
        blocks, ovs = [], []
        for v in range(2):
            # the root interpretation pinned to v
            sel = constant(np.eye(2)[:, v:v + 1], md.device, dtype)
            blocks.append(b0._replace(froot=b0.froot * sel,
                                      top=b0.top * sel))
            ovs.append(None)
    return blocks, ext_collapses(fb, cfg, ci=ci), ovs


def ext_blocks(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
               dtype=torch.float64):
    """``ext_block_list`` and the emissions: (blocks[v], e_ext
    [B, M, V, NS, S], collapses[v], root_overrides[v])."""
    blocks, collapses, ovs = ext_block_list(fb, cfg, ci=ci, dtype=dtype)
    e_ext = torch.stack([assemble_e_all(b, cfg) for b in blocks], dim=2)
    return blocks, e_ext, collapses, ovs


def _lam(cfg, params, dists, dtype, ratemat=None):
    return transition_eigenvalues(
        cfg, interval_recomb(cfg, params, dists, ratemat=ratemat)).to(dtype)


def extended_forward_backward(e_ext: torch.Tensor, dists: torch.Tensor,
                              fb: FamilyBatch, cfg: ModelConfig,
                              params: RuntimeParams,
                              ratemat=None) -> ExtFBResult:
    """Both sweeps over [B, M, V, NS, S] (``ops.fb.fb_ext``): the
    Walsh-Hadamard base-state transition times the [V, V] coupling per
    interval, from the prior ``_prior``."""
    dtype = e_ext.dtype
    lam = _lam(cfg, params, dists, dtype, ratemat)
    C = _vcoupling(fb, cfg, params, dists, dtype)
    return ExtFBResult(*fb_ext(e_ext, lam, C, _prior(fb, cfg, dtype)))


def _allowed(NS: int, shiftignore: torch.Tensor) -> torch.Tensor:
    return (torch.arange(NS, device=shiftignore.device)[None, :]
            & shiftignore[:, None]) == 0


def combined_loglik_ext(fbres: ExtFBResult,
                        shiftignore: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp of per-shift totals over the allowed shift modes."""
    allowed = _allowed(fbres.fw_post_f.shape[-1], shiftignore)
    f = torch.where(allowed, fbres.total_loglik, MINFACTOR)
    fmax = f.max(dim=-1, keepdim=True).values
    return fmax[..., 0] + torch.log(torch.where(
        allowed, torch.exp(f - fmax), 0.0).sum(dim=-1))


def posterior_weight_ext(fbres: ExtFBResult, total: torch.Tensor,
                         shiftignore: torch.Tensor) -> torch.Tensor:
    """W[b, m, v, s, g]: the per-(extension value, shift, state) probe
    weight."""
    allowed = _allowed(fbres.fw_pre_f.shape[-1], shiftignore)
    logw = fbres.fw_pre_f + fbres.bw_f - total[:, None, None]
    logw = torch.where(allowed[:, None, :], logw, MINFACTOR)
    return fbres.fw_pre * fbres.bw * torch.exp(logw)[:, :, None, :, None]


def turn_weights_ext(fbres: ExtFBResult, fb: FamilyBatch, cfg: ModelConfig,
                     total_desc_scale: bool = True) -> torch.Tensor:
    """Turn clause weights [B, M, T] over the extended space: the joint
    (state, shift) Walsh-Hadamard correlation of
    ``probes.turn_weights_fast`` summed over the extension axis (turn
    masks act as the identity there)."""
    B, M, V, NS, S = fbres.fw_post.shape
    dtype = fbres.fw_post.dtype
    X = S * NS
    allowed = _allowed(NS, fb.shiftignore)
    ff = torch.where(allowed[:, None, :], fbres.fw_post_f, -torch.inf)
    ffm = ff.max(dim=-1).values
    fexp = torch.where(allowed[:, None, :], torch.exp(ff - ffm[..., None]),
                       0.0)
    bf = fbres.bw_f
    bexp = torch.exp(bf - bf.max(dim=-1).values[..., None])
    fwp = (fbres.fw_post * fexp[:, :, None, :, None]).reshape(B, M, V, X)
    bwp = (fbres.bw * bexp[:, :, None, :, None]).reshape(B, M, V, X)
    D = fwht((fwht(fwp, -1) * fwht(bwp, -1)).sum(dim=2), -1) / X
    idx = constant(turn_offsets(cfg), D.device, torch.long)
    vals = D[..., idx]
    tiny = torch.finfo(dtype).tiny
    logv = torch.log(torch.clamp(vals, min=tiny))
    ok = vals > 0
    w = torch.where(ok & ok[..., 0:1], logv - logv[..., 0:1], MINFACTOR)
    if total_desc_scale:
        w = w * fb.descendants.to(dtype)[:, None, None]
    return w


def _shift_weights(f_left, f_right):
    """exp of the per-interval shift-mode log-weights, max-shifted."""
    logw = f_left + f_right
    return torch.exp(logw - logw.max(dim=-1, keepdim=True).values)


def _same_share(J: torch.Tensor) -> torch.Tensor:
    """same / total of a [B, M-1, 2, 2] joint (0.5 where empty), padded
    with a 0.5 column."""
    tot = J.sum(dim=(-1, -2))
    same = J[..., 0, 0] + J[..., 1, 1]
    ok = tot > 0
    c = torch.where(ok, same / torch.where(ok, tot, 1.0), 0.5)
    return torch.cat([c, c.new_full((c.shape[0], 1), 0.5)], dim=1)


def relskew_coherence_ext(fbres: ExtFBResult, e_ext: torch.Tensor,
                          fb: FamilyBatch, cfg: ModelConfig,
                          params: RuntimeParams, dists: torch.Tensor,
                          ratemat=None) -> torch.Tensor:
    """C[b, m]: posterior P(coherence bit equal at markers m, m+1) under
    RELSKEWSTATES, the EM statistic of relhaplo (last column 0.5): the
    pairwise joint over the V axis, fw_post[m, vf] . R_base .
    relscore[vf ^ vt] . (E[m+1, vt] * bw[m+1, vt]), weighted per shift
    mode."""
    assert cfg.relskewstates
    dtype = fbres.fw_post.dtype
    lam = _lam(cfg, params, dists, dtype, ratemat)
    C = _vcoupling(fb, cfg, params, dists, dtype)
    w = _shift_weights(fbres.fw_post_f[:, :-1], fbres.bw_f[:, 1:])
    xt = apply_transition(fbres.fw_post[:, :-1], lam[:, None, None, :])
    y = e_ext[:, 1:] * fbres.bw[:, 1:]
    # sum over states, then the shift weights, then the coupling
    G = torch.einsum("bmvns,bmwns->bmvwn", xt, y)
    J = torch.einsum("bmvwn,bmn->bmvw", G, w) * C
    return _same_share(J)


def coherence_slot_ext(fbres: ExtFBResult, blocks_v, fb: FamilyBatch,
                       cfg: ModelConfig, params: RuntimeParams,
                       dists: torch.Tensor, slot: int,
                       ratemat=None) -> torch.Tensor:
    """C[b, m]: posterior P(phase bit of ``slot`` equal at markers m, m+1)
    over an extended state space: the per-value phase-resolved emissions
    ride the V axis and the interval transition composes the base-state
    kernel with the V coupling."""
    dtype = fbres.fw_pre.dtype
    return slot_coherence_ext(fbres, blocks_v, fb, cfg,
                              _lam(cfg, params, dists, dtype, ratemat),
                              _vcoupling(fb, cfg, params, dists, dtype),
                              slot)


def slot_coherence_ext(fbres: ExtFBResult, blocks_v, fb: FamilyBatch,
                       cfg: ModelConfig, lam: torch.Tensor, C: torch.Tensor,
                       slot: int) -> torch.Tensor:
    """``coherence_slot_ext`` on given interval eigenvalues lam [M-1, S]
    and coupling C [B, M-1, V, V]."""
    from .hmm.probes import _phase_resolved_emission
    V = fbres.fw_pre.shape[2]
    e_j = torch.stack([_phase_resolved_emission(blocks_v[v], fb, cfg, slot)
                       for v in range(V)], dim=2)    # [B, M, V, j, NS, S]
    w = _shift_weights(fbres.fw_pre_f[:, :-1], fbres.bw_f[:, 1:])
    x = fbres.fw_pre[:, :-1, :, None] * e_j[:, :-1]
    xt = apply_transition(x, lam[:, None, None, None, :])
    xt = torch.einsum("bmfg,bmfjns->bmgjns", C, xt)
    y = e_j[:, 1:] * fbres.bw[:, 1:, :, None]
    G = torch.einsum("bmvins,bmvjns->bmijn", xt, y)
    J = torch.einsum("bmijn,bmn->bmij", G, w)
    return _same_share(J)


def coherence_ext(fbres: ExtFBResult, blocks_v, fb: FamilyBatch,
                  cfg: ModelConfig, params: RuntimeParams,
                  dists: torch.Tensor, ratemat=None) -> torch.Tensor:
    """C[b, m, slot]: SELFING's per-slot adjacent-phase coherence, every
    slot.  On the CPU the stack of ``coherence_slot_ext`` per slot
    (``ops.coherence.coherence_ext_reference``); on the card one launch
    of kernel #14 (``ops.coherence.coherence_ext``), which raises on what
    it does not take."""
    dtype = fbres.fw_pre.dtype
    lam = _lam(cfg, params, dists, dtype, ratemat)
    C = _vcoupling(fb, cfg, params, dists, dtype)
    if fbres.fw_pre.device.type == "cpu":
        return coherence_ext_reference(fbres, blocks_v, fb, cfg, lam, C)
    return coherence_ext_kernel(
        fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, lam, C,
        [b.froot for b in blocks_v], [b.pb[0] for b in blocks_v],
        [b.pb[1] for b in blocks_v], fb.flag2ignore, cfg)


def ext_update_masks(fb: FamilyBatch, cfg: ModelConfig, collapses):
    """[B, M, slot] haplo update mask per extension value: the standard
    one, and under SELFING the focal's duplicate-allele collapse of the
    value's own pair (collapses[v])."""
    from .hmm.probes import haplo_update_mask
    mask_std = haplo_update_mask(fb, cfg)
    masks = []
    for v, coll in enumerate(collapses):
        mask_v = mask_std
        if cfg.selfing:
            # the focal's duplicate-allele collapse (no haplo update)
            # tests the HBD-collapsed pair for selfval > 0
            mv0 = fb.exists[:, None, 0:1] & ~coll[:, :, None]
            first = mask_std[..., 0:1] & mv0 if v == 0 else mv0
            mask_v = torch.cat([first, mask_std[..., 1:]], dim=-1)
        masks.append(mask_v)
    return masks


def ext_statistics_per_v(W, blocks_v, ovs, fb: FamilyBatch,
                         cfg: ModelConfig, n_variants: int):
    """For each extension value v, the probe-dedup-variant average of the
    haplo / infprob statistics: yields (b12_v [B, M, 7, 2], inf_v
    [B, M, 7, 2, 2], pair_v [B, M, 2, 2]).  W: [B, M, V, NS, S] posterior
    weights.  The share tensors of the infprob probes depend on v's root
    only and the side-collapsed posterior on (v, variant) only, so each
    is computed once and shared (the JAX package's XLA program does the
    same by common-subexpression elimination)."""
    from .hmm.probes import (_valid_paths, haplo_stats, infprob_shares,
                             infprob_stats, probe_rule_factors,
                             side_collapse, _w_bits)

    dtype, dev = fb.ms.dtype, fb.ms.device
    B, M = fb.md.shape[0], fb.md.shape[2]
    S = cfg.numslots
    VP = [_valid_paths(fb.flag2ignore, k).to(dtype) for k in range(2)]
    # rule 3's scope: SELFING disables it, RELSKEWSTATES exempts the focal
    tied = "nonfocal" if cfg.relskewstates else False
    rule_factors = [probe_rule_factors(fb, cfg, dtype, w, tied_rule=tied)
                    for w in range(n_variants)]
    for v, blk in enumerate(blocks_v):
        PBm = [blk.pb[k] * VP[k][:, None, None, None, :, None]
               for k in range(2)]
        shares = infprob_shares(fb, cfg, dtype, root_override=ovs[v])
        Wv = W[:, :, v]
        Wr = _w_bits(Wv)
        b12_v = torch.zeros((B, M, S, 2), dtype=dtype, device=dev)
        inf_v = torch.zeros((B, M, S, 2, 2), dtype=dtype, device=dev)
        pair_v = torch.zeros((B, M, 2, 2), dtype=dtype, device=dev)
        for F0, FPs in rule_factors:
            frootw = blk.froot * F0
            PBw = [PBm[k] * FPs[k] for k in range(2)]
            t01 = side_collapse(PBw, Wr)
            b12_v += haplo_stats(Wv, blk, fb, cfg, t01=t01, froot=frootw,
                                 PB=PBw).b12
            ist = infprob_stats(Wv, blk, fb, cfg, t01=t01, froot=frootw,
                                PB=PBw, root_override=ovs[v],
                                drop_side1=cfg.relskewstates, shares=shares)
            inf_v += ist.accum
            pair_v += ist.pair
        yield tuple(x / n_variants for x in (b12_v, inf_v, pair_v))


def ext_statistics_reference(W, blocks_v, collapses, ovs, fb: FamilyBatch,
                             cfg: ModelConfig, n_variants: int):
    """The extended-space statistics from the posterior weights W
    [B, M, V, NS, S], on any device: per extension value v the
    probe-dedup-variant average of the haplo / infprob statistics
    (``ext_statistics_per_v``) and the selfing focal-collapse masking
    (``ext_update_masks``).  Returns (b12, mask, inf, pair)."""
    dtype, dev = fb.ms.dtype, fb.ms.device
    B, M = fb.md.shape[0], fb.md.shape[2]
    S = cfg.numslots
    b12 = torch.zeros((B, M, S, 2), dtype=dtype, device=dev)
    inf = torch.zeros((B, M, S, 2, 2), dtype=dtype, device=dev)
    pair = torch.zeros((B, M, 2, 2), dtype=dtype, device=dev)
    mask = torch.zeros((B, M, S), dtype=torch.bool, device=dev)
    per_v = ext_statistics_per_v(W, blocks_v, ovs, fb, cfg, n_variants)
    for mask_v, (b12_v, inf_v, pair_v) in zip(
            ext_update_masks(fb, cfg, collapses), per_v):
        mask = mask | mask_v
        b12 = b12 + torch.where(mask_v[..., None], b12_v, 0.0)
        inf = inf + inf_v
        pair = pair + pair_v
    return b12, mask, inf, pair


def ext_statistics(fbres: ExtFBResult, total: torch.Tensor,
                   fb: FamilyBatch, cfg: ModelConfig, n_variants: int):
    """The extended-space statistics (b12, mask, inf, pair) of a scan's
    sweeps and totals.  On the CPU each value's blocks
    (``ext_block_list``), the posterior weights and
    ``ext_statistics_reference``; on the card one launch of kernel #13
    (``ops.stats.stats_ext``: the blocks and weights formed inside it,
    none stored), then each value's update mask on its b12."""
    if fbres.fw_pre.device.type == "cpu":
        blocks_v, collapses, ovs = ext_block_list(fb, cfg,
                                                  dtype=fb.ms.dtype)
        W = posterior_weight_ext(fbres, total, fb.shiftignore)
        return ext_statistics_reference(W, blocks_v, collapses, ovs, fb,
                                        cfg, n_variants)
    b12_v, inf, pair = stats_ext(fb, fbres.fw_pre, fbres.bw, fbres.fw_pre_f,
                                 fbres.bw_f, total, cfg, n_variants)
    b12 = torch.zeros_like(b12_v[:, :, 0])
    mask = torch.zeros(b12.shape[:-1], dtype=torch.bool, device=b12.device)
    for v, mask_v in enumerate(ext_update_masks(fb, cfg,
                                                ext_collapses(fb, cfg))):
        mask = mask | mask_v
        b12 = b12 + torch.where(mask_v[..., None], b12_v[:, :, v], 0.0)
    return b12, mask, inf, pair


def chromosome_scan_ext(fb: FamilyBatch, dists: torch.Tensor,
                        cfg: ModelConfig, params: RuntimeParams,
                        ratemat=None, n_variants: int = 1,
                        with_coherence: bool = False):
    """One extended-state chromosome scan with the ScanResult contract of
    ``engine.chromosome_scan`` (totals, haplo / infprob statistics,
    genotype-pair posteriors, turn weights, coherence and the sweeps).
    n_variants: the probe-dedup sign variants (ignoreflag2's rule 2 stays
    active on the extended builds, and every selfed unit holds its parent
    in both parent slots): the Driver's ``_n_variants()``.  With
    ``with_coherence``: RELSKEWSTATES puts the coherence bit's
    xor-marginal in slot 0 (the other slots 0.5), SELFING the per-slot
    adjacent-phase coherence over the extended space."""
    from .engine import ScanResult

    dtype = fb.ms.dtype
    B, M = fb.md.shape[0], fb.md.shape[2]
    blocks_v, e_ext, _, _ = ext_blocks(fb, cfg, dtype=dtype)
    fbres = extended_forward_backward(e_ext, dists, fb, cfg, params,
                                      ratemat=ratemat)
    total = combined_loglik_ext(fbres, fb.shiftignore)
    b12, mask, inf, pair = ext_statistics(fbres, total, fb, cfg, n_variants)
    turn_w = turn_weights_ext(fbres, fb, cfg)
    coh = torch.full((B, M, cfg.numslots), 0.5, dtype=dtype,
                     device=fb.ms.device)
    if with_coherence and cfg.relskewstates:
        c0 = relskew_coherence_ext(fbres, e_ext, fb, cfg, params, dists,
                                   ratemat=ratemat)
        coh = torch.cat([c0[..., None], coh[..., 1:]], dim=-1)
    elif with_coherence and cfg.selfing:
        coh = coherence_ext(fbres, blocks_v, fb, cfg, params, dists,
                            ratemat=ratemat)
    return ScanResult(total=total, haplo_b12=b12, haplo_mask=mask,
                      inf_accum=inf, pair=pair, turn_weight=turn_w,
                      coherence=coh, fw_pre=fbres.fw_pre, bw=fbres.bw,
                      fw_pre_f=fbres.fw_pre_f, bw_f=fbres.bw_f)


def recombination_expectations_ext(fbres: ExtFBResult, e_ext: torch.Tensor,
                                   fb: FamilyBatch, cfg: ModelConfig,
                                   params: RuntimeParams, dists,
                                   ratemat=None) -> torch.Tensor:
    """P[b, m, t]: posterior probability that base meiosis bit t
    recombined in interval (m, m+1), over the extended space: the
    extended transition factors as R_base(g ^ g') x C(v, v'), so the
    pairwise joint's base-xor marginal is one coupling-weighted
    Walsh-Hadamard correlation per interval."""
    from .hmm.probes import lam_to_kernel
    B, M, V, NS, S = fbres.fw_post.shape
    dtype, dev = fbres.fw_post.dtype, fbres.fw_post.device
    lam = _lam(cfg, params, dists, dtype, ratemat)
    C = _vcoupling(fb, cfg, params, dists, dtype)
    xh = fwht(fbres.fw_post[:, :-1], -1)
    yh = fwht(e_ext[:, 1:] * fbres.bw[:, 1:], -1)
    z = sum(xh[:, :, f, None] * C[:, :, f, :, None, None] * yh
            for f in range(V)).sum(dim=2)              # [B, M-1, NS, S]
    z = fwht(z, -1) / S
    w = _shift_weights(fbres.fw_post_f[:, :-1], fbres.bw_f[:, 1:])
    z = (z * w[..., None]).sum(dim=2)                  # [B, M-1, S]
    p = torch.clamp(z, min=0.0) * lam_to_kernel(lam)
    tot = p.sum(dim=-1, keepdim=True)
    p = torch.where(tot > 0, p / torch.where(tot > 0, tot, 1.0), 0.0)
    x = torch.arange(S, device=dev)
    bits = ((x[:, None] >> torch.arange(cfg.typebits, device=dev)[None, :])
            & 1).to(dtype)
    return torch.einsum("bmx,xt->bmt", p, bits)


def recomb_expectations_ext(fb: FamilyBatch, dists: torch.Tensor, res,
                            cfg: ModelConfig, params: RuntimeParams,
                            ratemat=None) -> torch.Tensor:
    """The recombination expectations [B, M-1, typebits] from a scan's
    stored sweeps (fw_pre, bw and their factors): the emissions are
    rebuilt and the forward store renormalised (port of
    ``cnf2freq_tpu/engine_ext.py::make_jitted_recomb_ext``)."""
    _, e_ext, _, _ = ext_blocks(fb, cfg, dtype=res.fw_pre.dtype)
    fw_post, fw_post_f = emit_normalise_ext(res.fw_pre, e_ext, res.fw_pre_f)
    fbres = ExtFBResult(fw_pre=res.fw_pre, fw_post=fw_post, bw=res.bw,
                        fw_pre_f=res.fw_pre_f, fw_post_f=fw_post_f,
                        bw_f=res.bw_f)
    return recombination_expectations_ext(fbres, e_ext, fb, cfg, params,
                                          dists, ratemat=ratemat)
