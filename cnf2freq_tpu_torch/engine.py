"""Chromosome scan engine: one chromosome, one chunk of analysis units.

Port of the standard-space branches of ``cnf2freq_tpu/engine.py``, with
its rule: the feature-leading pipeline (ops/scan.py; emission, sweep,
statistics and turn kernels) unless the scan carries adjacent-phase
coherence, which runs the classic [B, M, NS, S] pipeline: emission
blocks -> sweeps (csrc/fb_classic.cu) -> total log-likelihood ->
statistics (the [B, M, NS, S] entry of csrc/stats.cu) -> turn weights ->
phase coherence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ModelConfig, RuntimeParams
from .hmm.family import FamilyBatch


class ScanResult(NamedTuple):
    total: torch.Tensor        # [B] combined log-likelihoods
    haplo_b12: torch.Tensor    # [B, M, 7, 2]
    haplo_mask: torch.Tensor   # [B, M, 7] bool
    inf_accum: torch.Tensor    # [B, M, 7, 2, 2]
    pair: torch.Tensor         # [B, M, 2, 2]
    turn_weight: torch.Tensor  # [B, M, T]
    coherence: torch.Tensor    # [B, M, 7] (neutral 0.5 unless measured)
    fw_pre: torch.Tensor       # [B, M, NS, S]
    bw: torch.Tensor
    fw_pre_f: torch.Tensor     # [B, M, NS]
    bw_f: torch.Tensor


def chromosome_scan(fb: FamilyBatch, dists: torch.Tensor, cfg: ModelConfig,
                    params: RuntimeParams, with_coherence: bool = False,
                    ratemat=None) -> ScanResult:
    """Every per-(chromosome, iteration) statistic of one chunk: totals,
    haplo/genotype update statistics, turn weights, pair posteriors and,
    with ``with_coherence``, the adjacent-phase coherence of every slot.
    ``with_coherence`` picks the pipeline: v2 without it, classic with
    it."""
    if cfg.selfing or cfg.relskewstates or cfg.numgen != 3 \
            or not cfg.haplotyping:
        raise NotImplementedError(
            "the port carries the default F2 haplotyping model only")
    if not with_coherence:
        from .ops.scan import chromosome_scan_v2
        return chromosome_scan_v2(fb, dists, cfg, params, ratemat=ratemat)

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
                                        cfg)
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
                num_individuals: int, with_coherence: bool = False):
    """Scan plus accumulator merge: per-family statistics segment-summed
    onto per-individual rows.  Returns (res, haplobase [NI, M],
    haplocount [NI, M], infacc [NI, M, 2, 2])."""
    from .parallel.collective import merge_haplos, merge_infprobs
    res = chromosome_scan(fb, dists, cfg, params,
                          with_coherence=with_coherence, ratemat=ratemat)
    hb, hc = merge_haplos(res.haplo_b12, res.haplo_mask, fb.hw, fb.slot_ind,
                          fb.descendants, lut, num_individuals)
    inf = merge_infprobs(res.inf_accum, fb.slot_ind, fb.descendants, lut,
                         num_individuals)
    return res, hb, hc, inf
