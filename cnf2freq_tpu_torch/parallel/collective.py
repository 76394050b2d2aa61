"""Accumulator merging: per-family statistics folded onto per-individual
rows with ``index_add_`` segment sums (port of
``cnf2freq_tpu/parallel/collective.py``), added in index order on every
device (``ordered_sums``), so that a rerun on the card reproduces every
bit.

Duplicate slots are folded with explicit broadcast sums over the 7x7
same-individual mask, not a matrix product, so no TF32 rounding applies
on the card.

Under a device mesh (``parallel.mesh``) each rank merges its own units
and the partial sums are added over the ranks of the mesh's "data" group
(``group=``, JAX's ``axis_name=`` and ``psum``); ``group=None`` is the
unmeshed run, where every collective here returns its inputs.  The one
collective is ``all_reduce(SUM)`` (``all_sum``): a gather of per-unit
outputs (``gather_units``) is the sum of zero-filled full-size buffers
into which each rank wrote its own rows, exact since every other term is
0.  Under gloo, PyTorch's backend table lists only ``broadcast`` and
``all_reduce`` for CUDA tensors; a backend that rejects a tensor raises,
and nothing is staged through the host in its place.  Every rank must
enter the collectives in the same order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..updates.scatter import _MOVEHAPLO_TINY, dup_masks, ordered_sums


def all_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over the ranks of ``group`` (new tensors): one
    ``all_reduce`` of the flattened concatenation per dtype, in the order
    the dtypes first appear.  Bool tensors travel as uint8 and come back
    as "any rank set it".  ``group=None`` (unmeshed): the tensors
    themselves."""
    if group is None:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        wire = torch.uint8 if t.dtype == torch.bool else t.dtype
        by_dtype.setdefault(wire, []).append(i)
    for wire, idx in by_dtype.items():
        flat = torch.cat([tensors[i].reshape(-1).to(wire) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            t = part.view(tensors[i].shape)
            out[i] = t > 0 if tensors[i].dtype == torch.bool else t
    return out


def gather_units(tensors: Sequence[torch.Tensor], n: int, group
                 ) -> List[torch.Tensor]:
    """Whole [n, ...] tensors from each rank's contiguous block of rows:
    rank r holds rows [r * per, r * per + len) with per = ceil(n / ranks)
    (``mesh.batch_sharding``); its rows past n (padding) are dropped.
    Every rank gets the same bits (a negative zero comes back as +0).
    ``group=None`` (unmeshed): the tensors themselves, n rows each."""
    if group is None:
        return list(tensors)
    nd, r = dist.get_world_size(group), dist.get_rank(group)
    per = -(-n // nd)
    lo = r * per
    k = max(0, min(per, n - lo))
    fulls = []
    for t in tensors:
        full = torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                           device=t.device)
        full[lo:lo + k] = t[:k]
        fulls.append(full)
    return all_sum(fulls, group)


def _segment_sum(flat: torch.Tensor, rows: torch.Tensor, n: int):
    """Sum rows of flat [K, ...] into n + 1 buckets, dropping the last
    (vacant-slot) bucket."""
    out = torch.zeros((n + 1,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    with ordered_sums():
        out.index_add_(0, rows.long(), flat)
    return out[:-1]


def merge_slot_stats(values: torch.Tensor, slot_ind: torch.Tensor,
                     num_individuals: int, group=None) -> torch.Tensor:
    """Fold [B, M, slot, ...] statistics onto [num_individuals, M, ...]
    accumulators; slot_ind holds global ids (0 = vacant, dropped).  With
    ``group`` the partial sums are added over its ranks."""
    B, M, S = values.shape[:3]
    flat = values.movedim(2, 1).reshape((B * S, M) + tuple(values.shape[3:]))
    out = torch.zeros((num_individuals + 1, M) + tuple(values.shape[3:]),
                      dtype=values.dtype, device=values.device)
    with ordered_sums():
        out.index_add_(0, slot_ind.reshape(B * S).long(), flat)
    return all_sum([out[1:]], group)[0]


def merge_haplos(b12, mask, hw, slot_ind, descendants, lut,
                 num_individuals: int, group=None):
    """movehaplos: b12 [B, M, S, 2] merged onto (haplobase [NI, M],
    haplocount [NI, M]).  hw: [B, S, M]; lut: individual id -> row
    (vacant -> num_individuals, dropped).  With ``group`` the partial
    sums are added over its ranks."""
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
    return tuple(all_sum([hb, hc], group))


def merge_infprobs(accum, slot_ind, descendants, lut, num_individuals: int,
                   emptyslot=None, group=None):
    """moveinfprobs: normalise by the focal's slot-0 mass, fold duplicate
    slots with 2/2^cnt damping, scale by descendants, segment-sum onto
    [NI, M, 2, 2].  With ``group`` the partial sums are added over its
    ranks."""
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
    return all_sum([_segment_sum(flat, rows.reshape(B * S),
                                 num_individuals)], group)[0]


def sharded_scan_merged(fb, dists, lut, ratemat, cfg, params,
                        num_individuals: int, group, n_real: int,
                        with_coherence: bool = False,
                        probe_rules: bool = False, n_variants: int = 1):
    """The scan and merge of one rank's units (port of
    ``make_sharded_scan_merged``): ``engine.scan_merged`` on ``fb``, the
    rank's block of a padded chunk whose first ``n_real`` units are real,
    with its merges summed over ``group``.  Returns (res, haplobase,
    haplocount, infacc, loglik): res holds the rank's units (totals, pair
    tables, turn weights, coherence; padded units' values are not to be
    read); the accumulators [NI, M, ...] and loglik, the real units'
    total log-likelihood, come back summed over the ranks.  With
    ``group=None`` it is the unmeshed chunk's scan_merged and loglik."""
    from ..engine import scan_merged
    res, hb, hc, inf = scan_merged(
        fb, dists, lut, ratemat, cfg, params, num_individuals,
        with_coherence=with_coherence, probe_rules=probe_rules,
        n_variants=n_variants, group=group)
    (loglik,) = all_sum([res.total[:n_real].sum()], group)
    return res, hb, hc, inf, loglik
