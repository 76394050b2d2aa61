"""Marker-blocked scans of the ng2 and extended (SELFING, RELSKEWSTATES)
model families.

Port of ``cnf2freq_tpu/blocked_families.py``.  The standard 64-state space
has its own blocked pipeline (``ops.scan.blocked_carries`` /
``blocked_block_pass``); this module gives the 4-state numgen == 2 engine
and the extended (V x 64) spaces the same O(block) device memory, as the
reference's fillortake block tree does under every settings.h config
(cnF2freq.cpp:1675-1776).  Per (batch chunk, chromosome), three phases:

  A. forward carries: per block, the block's emissions and the forward
     sweep carry-only (``ops.fb.fb_small_carry`` / ``fb_ext_carry``); the
     carry entering each block is kept, and the last one gives the
     per-unit totals;
  B. backward carries, last block first: the carry is bw at a block's
     last marker, and the step at the block's first marker crosses the
     interval below it (lam and, on the extended spaces, the unit's
     coupling C[:, off - 1] in the forward from -> to orientation);
  C. per block: the emissions again, both sweeps with their stores from
     the boundary carries (``fb_small_block`` / ``fb_ext_block``), the
     family's statistics against the whole chromosome's totals and the
     per-individual merges of the block's markers.

The port's carries follow its F2 blocked scan (``ops/scan.py``); the JAX
module's backward "z-form" carries the post-emission state instead, with
the same float operations in the same order, so both give the
whole-chromosome sweep's values exactly.  The marker axis of a batch is a
multiple of the block (``parallel.mesh.pad_markers``); the padded
intervals have distance 0, and the padded markers' emissions are set to
1, so that they leave the totals unchanged (their own emissions are
state-constant, but not 1: 0.5 under RELSKEWSTATES, where the JAX
module's totals take log 0.5 a padded marker and unit).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from .config import MINFACTOR, ModelConfig, RuntimeParams
from .hmm.family import FamilyBatch
from .hmm.transition import interval_recomb, transition_eigenvalues
from .ops import fb as pfb
from .ops.scan import blocked_slice

Carry = Tuple[torch.Tensor, torch.Tensor]


class FamilyCarries(NamedTuple):
    """Phases A and B of one batch chunk: the padded interval tensors,
    the totals and the carries at every block boundary (``fbound[i]``
    enters block i forward, ``bbound[i]`` is bw at block i's last
    marker)."""
    lam_pad: torch.Tensor            # [Mp, S]: ones after the last marker
    C_pad: Optional[torch.Tensor]    # [B, Mp, V, V]: the identity there
    n_markers: int                   # the real markers, before padding
    total: torch.Tensor              # [B]
    fbound: List[Carry]
    bbound: List[Carry]


def is_ext(cfg: ModelConfig) -> bool:
    return bool(cfg.selfing or cfg.relskewstates)


def check_family(cfg: ModelConfig) -> None:
    """The families this module scans: ng2 with haplotyping and the
    extended spaces."""
    if not (is_ext(cfg) or cfg.numgen == 2):
        raise ValueError("the standard space runs ops.scan's blocked scan")
    if not is_ext(cfg) and not cfg.haplotyping:
        raise NotImplementedError(
            "blocked mode: the no-haplotyping deep-walk engine is "
            "whole-chromosome only")


def prep_intervals(fb: FamilyBatch, dists: torch.Tensor, ratemat,
                   cfg: ModelConfig, params: RuntimeParams):
    """The whole chromosome's interval tensors (small, O(M)): (lam_pad
    [Mp, S], padded with ones, and on the extended spaces C_pad
    [B, Mp, V, V], padded with the identity; else None)."""
    dt = fb.ms.dtype
    lam = transition_eigenvalues(cfg, interval_recomb(
        cfg, params, dists, ratemat=ratemat)).to(dt)
    lam_pad = pfb.pad_lam(lam, dt, cfg.numtypes).contiguous()
    if not is_ext(cfg):
        return lam_pad, None
    from .engine_ext import _vcoupling
    C = _vcoupling(fb, cfg, params, dists, dt)
    return lam_pad, pfb.pad_coupling(C, dt).contiguous()


def block_emission(fb_blk: FamilyBatch, cfg: ModelConfig, n_real: int):
    """(blocks, e) of one block whose first ``n_real`` markers are real
    (the rest padding, whose e is set to 1): ng2's (froot, P2, top,
    focal_attop) and e [B, K, 2, 4], or the extended (blocks_v,
    collapses, ovs) and e [B, K, V, NS, 64]."""
    dt = fb_blk.ms.dtype
    if is_ext(cfg):
        from .engine_ext import ext_blocks
        blocks_v, e, collapses, ovs = ext_blocks(fb_blk, cfg, dtype=dt)
        em = (blocks_v, collapses, ovs)
    else:
        from .engine_ng2 import assemble_e_ng2, ng2_blocks
        em = ng2_blocks(fb_blk, cfg, dtype=dt)
        e = assemble_e_ng2(*em, fb_blk, cfg)
    e = e.contiguous()
    if n_real < e.shape[1]:
        e[:, n_real:] = 1.0
    return em, e


def _interval(lam_pad, C_pad, sl):
    """The block's rows of the interval tensors (contiguous)."""
    C = None if C_pad is None else C_pad[:, sl].contiguous()
    return lam_pad[sl], C


def total_from_factors(f: torch.Tensor,
                       shiftignore: torch.Tensor) -> torch.Tensor:
    """Per-unit totals [B] from the forward carry's log-factors f [B, NS]
    after the last marker's emission: the log-sum-exp over the allowed
    shift modes (``combined_loglik``'s arithmetic)."""
    NS = f.shape[-1]
    allowed = (torch.arange(NS, device=f.device)[None, :]
               & shiftignore[:, None]) == 0
    f = torch.where(allowed, f, MINFACTOR)
    fmax = f.max(dim=-1, keepdim=True).values
    return fmax[..., 0] + torch.log(torch.where(
        allowed, torch.exp(f - fmax), 0.0).sum(dim=-1))


def _real(n_markers: int, i: int, block: int) -> int:
    """Real markers of block i."""
    return min(block, n_markers - i * block)


def pass_a(fb: FamilyBatch, lam_pad, C_pad, cfg: ModelConfig, block: int,
           n_markers: int):
    """Phase A: the forward sweep carry-only, block by block, from the
    whole-chromosome seed (1/4 on ng2; the prior of ``engine_ext._prior``
    from block 0's family data on the extended spaces).  Returns the
    carry entering each block and the one after the last."""
    fbound = []
    carry = None
    for i in range(fb.md.shape[2] // block):
        sl = slice(i * block, (i + 1) * block)
        fb_blk = blocked_slice(fb, i, block)
        _, e = block_emission(fb_blk, cfg, _real(n_markers, i, block))
        lam_blk, C_blk = _interval(lam_pad, C_pad, sl)
        if is_ext(cfg):
            if carry is None:
                from .engine_ext import _prior
                carry = pfb.ext_prior_seed(e, _prior(fb_blk, cfg, e.dtype))
            fbound.append(carry)
            carry = pfb.fb_ext_carry(e, lam_blk, C_blk, carry)
        else:
            if carry is None:
                carry = pfb.seed_carry(e, 1.0 / cfg.numtypes)
            fbound.append(carry)
            carry = pfb.fb_small_carry(e, lam_blk, carry)
    return fbound, carry


def pass_b(fb: FamilyBatch, lam_pad, C_pad, cfg: ModelConfig, block: int,
           n_markers: int, seed: Carry) -> List[Carry]:
    """Phase B: the backward sweep carry-only from ``seed`` (ones, zero
    log-factors) at the chromosome's end, last block first (block 0 has
    no boundary below it, and is not swept).  Returns bw at each block's
    last marker."""
    nblk = fb.md.shape[2] // block
    bbound = [None] * nblk
    carry = seed
    for i in range(nblk - 1, 0, -1):
        sl = slice(i * block, (i + 1) * block)
        _, e = block_emission(blocked_slice(fb, i, block), cfg,
                              _real(n_markers, i, block))
        bbound[i] = carry
        lam_blk, C_blk = _interval(lam_pad, C_pad, sl)
        below = i * block - 1
        if is_ext(cfg):
            carry = pfb.fb_ext_carry(e, lam_blk, C_blk, carry, backward=True,
                                     lam_below=lam_pad[below],
                                     C_below=C_pad[:, below])
        else:
            carry = pfb.fb_small_carry(e, lam_blk, carry, backward=True,
                                       lam_below=lam_pad[below])
    bbound[0] = carry
    return bbound


def family_carries(fb: FamilyBatch, dists: torch.Tensor, ratemat,
                   cfg: ModelConfig, params: RuntimeParams, block: int,
                   n_markers: Optional[int] = None) -> FamilyCarries:
    """Phases A and B of one batch chunk, whose marker axis is a multiple
    of ``block`` (the first ``n_markers`` real, by default all): the
    carry-only sweeps that keep only the carries at block boundaries,
    and the totals."""
    check_family(cfg)
    M = fb.md.shape[2]
    if M % block:
        raise ValueError(f"{M} markers is not a multiple of block {block}")
    n_markers = M if n_markers is None else n_markers
    lam_pad, C_pad = prep_intervals(fb, dists, ratemat, cfg, params)
    fbound, (_, f) = pass_a(fb, lam_pad, C_pad, cfg, block, n_markers)
    p0, f0 = fbound[0]
    bbound = pass_b(fb, lam_pad, C_pad, cfg, block, n_markers,
                    (torch.ones_like(p0), torch.zeros_like(f0)))
    return FamilyCarries(lam_pad, C_pad, n_markers,
                         total_from_factors(f, fb.shiftignore), fbound,
                         bbound)


def _stats_ng2(em, fbres, fb_blk, total, cfg, with_turn):
    from .engine_ng2 import (haplo_stats_ng2, haplo_update_mask_ng2,
                             infprob_stats_ng2)
    from .hmm.probes import posterior_weight, turn_weights_fast_reference
    froot, P2, _, _ = em
    W = posterior_weight(fbres, total, fb_blk.shiftignore)
    b12 = haplo_stats_ng2(W, froot, P2, fb_blk, cfg)
    mask = haplo_update_mask_ng2(fb_blk, cfg)
    inf, pair = infprob_stats_ng2(W, froot, P2, fb_blk, cfg)
    del W
    turn_w = turn_weights_fast_reference(fbres, fb_blk, cfg) \
        if with_turn else None
    return pair, b12, mask, inf, turn_w


def _stats_ext(em, fbres, fb_blk, total, cfg, with_turn, n_variants):
    # the extended statistics restricted to the block's markers (W is
    # marker-local given the whole chromosome's totals)
    from .engine_ext import (ext_statistics, posterior_weight_ext,
                             turn_weights_ext)
    blocks_v, collapses, ovs = em
    W = posterior_weight_ext(fbres, total, fb_blk.shiftignore)
    b12, mask, inf, pair = ext_statistics(W, blocks_v, collapses, ovs,
                                          fb_blk, cfg, n_variants)
    del W
    turn_w = turn_weights_ext(fbres, fb_blk, cfg) if with_turn else None
    return pair, b12, mask, inf, turn_w


def family_block_pass(fb: FamilyBatch, fc: FamilyCarries, i: int,
                      block: int, lut: torch.Tensor, cfg: ModelConfig,
                      num_individuals: int, n_variants: int = 1,
                      with_turn: bool = True):
    """Phase C for one (batch chunk, block): the block's sweeps with
    stores from its boundary carries, the family's statistics, the merges
    (the infprob merge counting non-empty slots only on the extended
    spaces, as their unblocked scan does) and (``with_turn``) the turn
    weights.  Returns (pair [B, K, 2, 2], hb, hc [NI, K], inf
    [NI, K, 2, 2], turn_w [B, K, T] or None)."""
    from .engine_ext import ExtFBResult
    from .hmm.forward_backward import FBResult
    from .parallel.collective import merge_haplos, merge_infprobs
    sl = slice(i * block, (i + 1) * block)
    fb_blk = blocked_slice(fb, i, block)
    em, e = block_emission(fb_blk, cfg, _real(fc.n_markers, i, block))
    lam_blk, C_blk = _interval(fc.lam_pad, fc.C_pad, sl)
    if is_ext(cfg):
        fbres = ExtFBResult(*pfb.fb_ext_block(e, lam_blk, C_blk, fc.fbound[i],
                                              fc.bbound[i]))
        del e
        out = _stats_ext(em, fbres, fb_blk, fc.total, cfg, with_turn,
                         n_variants)
    else:
        fbres = FBResult(*pfb.fb_small_block(e, lam_blk, fc.fbound[i],
                                             fc.bbound[i]))
        del e
        out = _stats_ng2(em, fbres, fb_blk, fc.total, cfg, with_turn)
    del fbres
    pair, b12, mask, inf, turn_w = out
    hb, hc = merge_haplos(b12, mask, fb_blk.hw, fb_blk.slot_ind,
                          fb_blk.descendants, lut, num_individuals)
    infm = merge_infprobs(inf, fb_blk.slot_ind, fb_blk.descendants, lut,
                          num_individuals,
                          emptyslot=fb_blk.emptyslot if is_ext(cfg) else None)
    return pair, hb, hc, infm, turn_w


def blocked_family_chunk(fb: FamilyBatch, dists: torch.Tensor, ratemat,
                         lut: torch.Tensor, cfg: ModelConfig,
                         params: RuntimeParams, block: int,
                         num_individuals: int, n_variants: int = 1,
                         with_turn: bool = True,
                         n_markers: Optional[int] = None,
                         carries: Optional[FamilyCarries] = None):
    """One batch chunk's chromosome (its first ``n_markers`` markers real,
    by default all) through phases A-C, as a generator over its blocks:
    yields ``(i, pair, hb, hc, inf, turn_w)`` per block (O(block) sweep
    memory plus the boundary carries).  ``carries`` passes phases A and B
    already run (``family_carries``)."""
    if carries is None:
        carries = family_carries(fb, dists, ratemat, cfg, params, block,
                                 n_markers)
    for i in range(fb.md.shape[2] // block):
        yield (i,) + family_block_pass(fb, carries, i, block, lut, cfg,
                                       num_individuals, n_variants,
                                       with_turn)
