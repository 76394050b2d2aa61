"""Accumulator merging: per-family statistics folded onto per-individual
rows with ``index_add_`` segment sums (port of the single-device part of
``cnf2freq_tpu/parallel/collective.py``; no mesh).

Duplicate slots are folded with explicit broadcast sums over the 7x7
same-individual mask, not a matrix product, so no TF32 rounding applies
on the card.
"""

from __future__ import annotations

import torch

from ..updates.scatter import _MOVEHAPLO_TINY, dup_masks


def _segment_sum(flat: torch.Tensor, rows: torch.Tensor, n: int):
    """Sum rows of flat [K, ...] into n + 1 buckets, dropping the last
    (vacant-slot) bucket."""
    out = torch.zeros((n + 1,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    out.index_add_(0, rows.long(), flat)
    return out[:-1]


def merge_slot_stats(values: torch.Tensor, slot_ind: torch.Tensor,
                     num_individuals: int) -> torch.Tensor:
    """Fold [B, M, slot, ...] statistics onto [num_individuals, M, ...]
    accumulators; slot_ind holds global ids (0 = vacant, dropped)."""
    B, M, S = values.shape[:3]
    flat = values.movedim(2, 1).reshape((B * S, M) + tuple(values.shape[3:]))
    out = torch.zeros((num_individuals + 1, M) + tuple(values.shape[3:]),
                      dtype=values.dtype, device=values.device)
    out.index_add_(0, slot_ind.reshape(B * S).long(), flat)
    return out[1:]


def merge_haplos(b12, mask, hw, slot_ind, descendants, lut,
                 num_individuals: int):
    """movehaplos: b12 [B, M, S, 2] merged onto (haplobase [NI, M],
    haplocount [NI, M]).  hw: [B, S, M]; lut: individual id -> row
    (vacant -> num_individuals, dropped)."""
    B, M, S = b12.shape[:3]
    dtype = b12.dtype
    eq, first = dup_masks(slot_ind)
    eqf = eq.to(dtype)

    masked = torch.where(mask[..., None], b12, 0.0)
    tot = (eqf[:, None, :, :, None] * masked[:, :, None, :, :]).sum(dim=3)
    used_slot = (mask & (b12.sum(dim=-1) > 0)).to(dtype)
    used = (eqf[:, None, :, :] * used_slot[:, :, None, :]).sum(dim=3) > 0

    unlocked = (hw - 0.5).abs() < 0.5 - 1e-12             # [B, S, M]
    take = used & unlocked.transpose(1, 2)
    b1 = tot[..., 0] + _MOVEHAPLO_TINY
    b2 = tot[..., 1] + _MOVEHAPLO_TINY
    den = b1 + b2
    safe = take & torch.isfinite(den) & (den > 0)
    d = descendants[:, None, None].to(dtype)
    contrib = torch.where(safe, b1 / torch.where(safe, den, 1.0), 0.0) * d
    count = torch.where(safe, 1.0, 0.0).to(dtype) * d

    rows = torch.where(first, lut[slot_ind.long()], num_individuals)
    rows_flat = rows.reshape(B * S)
    hb = _segment_sum(contrib.movedim(2, 1).reshape(B * S, M), rows_flat,
                      num_individuals)
    hc = _segment_sum(count.movedim(2, 1).reshape(B * S, M), rows_flat,
                      num_individuals)
    return hb, hc


def merge_infprobs(accum, slot_ind, descendants, lut, num_individuals: int,
                   emptyslot=None):
    """moveinfprobs: normalise by the focal's slot-0 mass, fold duplicate
    slots with 2/2^cnt damping, scale by descendants, segment-sum onto
    [NI, M, 2, 2]."""
    B, M, S = accum.shape[:3]
    dtype = accum.dtype
    eq, first = dup_masks(slot_ind)
    eqf = eq.to(dtype)
    cnt_in = eq if emptyslot is None else eq & ~emptyslot[:, None, :]
    cnt = cnt_in.sum(dim=2).to(dtype)                     # [B, S]

    fsum = accum[:, :, 0, 0, :].sum(dim=-1)               # [B, M]
    inv = torch.where(fsum > 0, 1.0 / torch.where(fsum > 0, fsum, 1.0), 0.0)
    tot = (eqf[:, None, :, :, None, None] *
           accum[:, :, None, :, :, :]).sum(dim=3)         # [B, M, S, 2, 2]
    norm = 2.0 / torch.exp2(cnt) * descendants[:, None].to(dtype)
    contrib = tot * inv[:, :, None, None, None] * \
        norm[:, None, :, None, None]

    rows = torch.where(first, lut[slot_ind.long()], num_individuals)
    flat = contrib.movedim(2, 1).reshape(B * S, M, 2, 2)
    return _segment_sum(flat, rows.reshape(B * S), num_individuals)
