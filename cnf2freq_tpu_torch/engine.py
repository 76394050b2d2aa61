"""Chromosome scan engine: one chromosome, one chunk of analysis units.

Port of the standard branch of ``cnf2freq_tpu/engine.py``: the port
always runs the feature-leading pipeline (ops/scan.py), whose emission,
sweep, statistics and turn stages are CUDA kernels on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cnf2freq_tpu.config import ModelConfig, RuntimeParams

from .hmm.family import FamilyBatch


class ScanResult(NamedTuple):
    total: torch.Tensor        # [B] combined log-likelihoods
    haplo_b12: torch.Tensor    # [B, M, 7, 2]
    haplo_mask: torch.Tensor   # [B, M, 7] bool
    inf_accum: torch.Tensor    # [B, M, 7, 2, 2]
    pair: torch.Tensor         # [B, M, 2, 2]
    turn_weight: torch.Tensor  # [B, M, T]
    coherence: torch.Tensor    # [B, M, 7] (neutral 0.5: not measured)
    fw_pre: torch.Tensor       # [B, M, NS, S]
    bw: torch.Tensor
    fw_pre_f: torch.Tensor     # [B, M, NS]
    bw_f: torch.Tensor


def chromosome_scan(fb: FamilyBatch, dists: torch.Tensor, cfg: ModelConfig,
                    params: RuntimeParams, ratemat=None) -> ScanResult:
    """Every per-(chromosome, iteration) statistic of one chunk: totals,
    haplo/genotype update statistics, turn weights, pair posteriors."""
    if cfg.selfing or cfg.relskewstates or cfg.numgen != 3 \
            or not cfg.haplotyping:
        raise NotImplementedError(
            "the port carries the default F2 haplotyping model only")
    from .ops.scan import chromosome_scan_v2
    return chromosome_scan_v2(fb, dists, cfg, params, ratemat=ratemat)


def scan_merged(fb: FamilyBatch, dists: torch.Tensor, lut: torch.Tensor,
                ratemat, cfg: ModelConfig, params: RuntimeParams,
                num_individuals: int):
    """Scan plus accumulator merge: per-family statistics segment-summed
    onto per-individual rows.  Returns (res, haplobase [NI, M],
    haplocount [NI, M], infacc [NI, M, 2, 2])."""
    from .parallel.collective import merge_haplos, merge_infprobs
    res = chromosome_scan(fb, dists, cfg, params, ratemat=ratemat)
    hb, hc = merge_haplos(res.haplo_b12, res.haplo_mask, fb.hw, fb.slot_ind,
                          fb.descendants, lut, num_individuals)
    inf = merge_infprobs(res.inf_accum, fb.slot_ind, fb.descendants, lut,
                         num_individuals)
    return res, hb, hc, inf
