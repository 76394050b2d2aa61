"""Chromosome scan engine: one chromosome, one chunk of analysis units.

Port of ``cnf2freq_tpu/engine.py``, with its rules.  The extended state
spaces (``ModelConfig(selfing=True)``, ``ModelConfig(relskewstates=
True)``) run ``engine_ext`` (sweeps in csrc/fb_ext.cu, plain statistics);
a numgen == 2 config runs its dedicated engine: ``engine_ng2`` (4 states
x 2 shift modes over 3 slots, with haplotyping) or ``engine_nohaplo`` (4
states, the deep 7-slot walk, no haplotyping).  The 64-state space runs
the feature-leading pipeline
(ops/scan.py; emission, sweep, statistics and turn kernels) unless the
scan carries adjacent-phase coherence, which runs the classic
[B, M, NS, S] pipeline: emission blocks -> sweeps (csrc/fb_classic.cu)
-> total log-likelihood -> statistics (the [B, M, NS, S] entry of
csrc/stats.cu) -> turn weights -> phase coherence.  Two reporters run
their own pass over a chunk: the line-origin classes (``line_origin``, a
fresh forward/backward through csrc/fb_classic.cu) and the recombination
expectations of the genetic-map re-estimation (``recomb_expectations``,
from a scan's sweeps).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ModelConfig, RuntimeParams
from .hmm.family import FamilyBatch


class ScanResult(NamedTuple):
    total: torch.Tensor        # [B] combined log-likelihoods
    haplo_b12: torch.Tensor    # [B, M, slots, 2]
    haplo_mask: torch.Tensor   # [B, M, slots] bool
    inf_accum: torch.Tensor    # [B, M, slots, 2, 2]
    pair: torch.Tensor         # [B, M, 2, 2]
    turn_weight: torch.Tensor  # [B, M, T]
    coherence: torch.Tensor    # [B, M, slots] (0.5 unless measured)
    fw_pre: torch.Tensor       # [B, M, NS, S]
    bw: torch.Tensor
    fw_pre_f: torch.Tensor     # [B, M, NS]
    bw_f: torch.Tensor


def chromosome_scan(fb: FamilyBatch, dists: torch.Tensor, cfg: ModelConfig,
                    params: RuntimeParams, with_coherence: bool = False,
                    ratemat=None, probe_rules: bool = False,
                    n_variants: int = 1) -> ScanResult:
    """Every per-(chromosome, iteration) statistic of one chunk: totals,
    haplo/genotype update statistics, turn weights, pair posteriors and,
    with ``with_coherence``, the adjacent-phase coherence of every slot.
    ``with_coherence`` picks the pipeline: v2 without it, classic with
    it.  ``probe_rules`` (parity mode): the statistics with the
    ignoreflag2 rule 2-3 probe-dedup factors, averaged over the first
    ``n_variants`` dup-flip variants (on the extended spaces the
    ignoreflag2 rule 2 applies always, over ``n_variants``)."""
    if cfg.selfing or cfg.relskewstates:
        if probe_rules:
            raise NotImplementedError(
                "probe dedup rules are standard-space only")
        from .engine_ext import chromosome_scan_ext
        return chromosome_scan_ext(fb, dists, cfg, params, ratemat=ratemat,
                                   n_variants=n_variants,
                                   with_coherence=with_coherence)
    if cfg.numgen == 2:
        if probe_rules:
            raise NotImplementedError(
                "probe dedup rules (parity mode) need numgen == 3")
        if cfg.deep_walk:
            from .engine_nohaplo import chromosome_scan_nohaplo
            return chromosome_scan_nohaplo(fb, dists, cfg, params,
                                           ratemat=ratemat)
        from .engine_ng2 import chromosome_scan_ng2
        return chromosome_scan_ng2(fb, dists, cfg, params, ratemat=ratemat,
                                   with_coherence=with_coherence)
    if not cfg.haplotyping:
        raise NotImplementedError("a numgen == 3 model without haplotyping "
                                  "has no engine")
    if not with_coherence:
        from .ops.scan import chromosome_scan_v2
        return chromosome_scan_v2(fb, dists, cfg, params, ratemat=ratemat,
                                  probe_rules=probe_rules,
                                  n_variants=n_variants)

    from .hmm.emission import assemble_e_all, build_blocks
    from .hmm.forward_backward import combined_loglik, forward_backward
    from .hmm.probes import (haplo_update_mask, phase_coherence,
                             turn_weights_fast)
    from .hmm.transition import interval_recomb, transition_eigenvalues
    from .ops.stats import stats_pallas

    dtype = fb.ms.dtype
    blocks = build_blocks(fb, cfg, dtype=dtype)
    e = assemble_e_all(blocks, cfg)
    fbres = forward_backward(e, dists, cfg, params, ratemat=ratemat)
    del e
    total = combined_loglik(fbres, fb.shiftignore)
    b12, inf_accum, pair = stats_pallas(fb, fbres.fw_pre, fbres.bw,
                                        fbres.fw_pre_f, fbres.bw_f, total,
                                        cfg, probe_rules=probe_rules,
                                        n_variants=n_variants)
    hmask = haplo_update_mask(fb, cfg)
    turn_w = turn_weights_fast(fbres, fb, cfg)
    lam = transition_eigenvalues(
        cfg, interval_recomb(cfg, params, dists, ratemat=ratemat)).to(dtype)
    coh = phase_coherence(fbres, blocks, fb, cfg, lam)
    return ScanResult(total=total, haplo_b12=b12, haplo_mask=hmask,
                      inf_accum=inf_accum, pair=pair, turn_weight=turn_w,
                      coherence=coh, fw_pre=fbres.fw_pre, bw=fbres.bw,
                      fw_pre_f=fbres.fw_pre_f, bw_f=fbres.bw_f)


def scan_merged(fb: FamilyBatch, dists: torch.Tensor, lut: torch.Tensor,
                ratemat, cfg: ModelConfig, params: RuntimeParams,
                num_individuals: int, with_coherence: bool = False,
                probe_rules: bool = False, n_variants: int = 1):
    """Scan plus accumulator merge: per-family statistics segment-summed
    onto per-individual rows (under ``probe_rules`` the infprob merge's
    duplicate-slot damping counts non-empty slots only, as the
    reference's reltreeordered holds only non-empty members; so it does
    on the extended spaces, whose dedup rule 2 is always on).  Returns
    (res, haplobase [NI, M], haplocount [NI, M], infacc [NI, M, 2, 2]).
    The numgen == 2 families take their engines' forms."""
    from .parallel.collective import merge_haplos, merge_infprobs
    if cfg.numgen == 2 and not probe_rules:
        if cfg.deep_walk:
            from .engine_nohaplo import scan_merged_nohaplo as merged
        else:
            from .engine_ng2 import scan_merged_ng2 as merged
        return merged(fb, dists, lut, ratemat, cfg, params, num_individuals,
                      with_coherence=with_coherence)
    res = chromosome_scan(fb, dists, cfg, params,
                          with_coherence=with_coherence, ratemat=ratemat,
                          probe_rules=probe_rules, n_variants=n_variants)
    hb, hc = merge_haplos(res.haplo_b12, res.haplo_mask, fb.hw, fb.slot_ind,
                          fb.descendants, lut, num_individuals)
    inf = merge_infprobs(res.inf_accum, fb.slot_ind, fb.descendants, lut,
                         num_individuals,
                         emptyslot=fb.emptyslot if (
                             probe_rules or cfg.selfing or
                             cfg.relskewstates) else None)
    return res, hb, hc, inf


def line_origin(fb: FamilyBatch, dists: torch.Tensor, cfg: ModelConfig,
                params: RuntimeParams, ratemat=None) -> torch.Tensor:
    """Line-origin class posteriors [B, M, 3] of one chunk: the
    zeropropagate gstr reporter (``probes.line_origin_posterior``) on a
    fresh forward/backward (port of
    ``cnf2freq_tpu/engine.py::make_jitted_line_origin``; the deep-walk
    no-haplotyping family counts at its own depth,
    ``engine_nohaplo.nohaplo_line_origin``)."""
    if cfg.selfing or cfg.relskewstates:
        raise ValueError("line-origin reporter supports the standard "
                         "state space only")
    if cfg.deep_walk:
        from .engine_nohaplo import line_origin_nohaplo
        return line_origin_nohaplo(fb, dists, cfg, params, ratemat=ratemat)
    if cfg.numgen == 2:
        raise NotImplementedError(
            "no line-origin reporter for the numgen == 2 haplotyping family "
            "(the JAX package's reporter builds 7-slot blocks only)")
    from .hmm.emission import assemble_e_all, build_blocks
    from .hmm.forward_backward import combined_loglik, forward_backward
    from .hmm.probes import line_origin_posterior, posterior_weight
    blocks = build_blocks(fb, cfg, dtype=fb.ms.dtype)
    e = assemble_e_all(blocks, cfg)
    fbres = forward_backward(e, dists, cfg, params, ratemat=ratemat)
    del e
    total = combined_loglik(fbres, fb.shiftignore)
    W = posterior_weight(fbres, total, fb.shiftignore)
    return line_origin_posterior(W, blocks, fb, cfg)


def recomb_expectations(fb: FamilyBatch, dists: torch.Tensor,
                        res: ScanResult, cfg: ModelConfig,
                        params: RuntimeParams, ratemat=None) -> torch.Tensor:
    """Posterior per-interval, per-meiosis-bit recombination expectations
    [B, M-1, typebits] from a scan's sweeps (port of
    ``cnf2freq_tpu/engine.py::make_jitted_recomb``; the extended spaces
    take ``engine_ext.recomb_expectations_ext``)."""
    if cfg.selfing or cfg.relskewstates:
        from .engine_ext import recomb_expectations_ext
        return recomb_expectations_ext(fb, dists, res, cfg, params,
                                       ratemat=ratemat)
    from .hmm.emission import assemble_e_all, build_blocks
    from .hmm.forward_backward import FBResult
    from .hmm.probes import recombination_expectations
    from .hmm.transition import interval_recomb, transition_eigenvalues
    dtype = res.fw_pre.dtype
    e = assemble_e_all(build_blocks(fb, cfg, dtype=dtype), cfg)
    lam = transition_eigenvalues(
        cfg, interval_recomb(cfg, params, dists, ratemat=ratemat)).to(dtype)
    pe = res.fw_pre * e
    s = pe.sum(dim=-1, keepdim=True)
    fw_post = torch.where(s > 0, pe / torch.where(s > 0, s, 1.0), 0.0)
    fw_post_f = res.fw_pre_f + torch.log(torch.clamp(s[..., 0], min=1e-300))
    fbres = FBResult(fw_pre=res.fw_pre, fw_post=fw_post, bw=res.bw,
                     fw_pre_f=res.fw_pre_f, fw_post_f=fw_post_f,
                     bw_f=res.bw_f)
    return recombination_expectations(fbres, e, cfg, lam)
