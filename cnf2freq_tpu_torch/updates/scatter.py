"""Accumulator-scatter helpers shared by the merges.

Port of the pieces of ``cnf2freq_tpu/updates/scatter.py`` that the
non-resident iteration uses: the movehaplos tiny term, the duplicate-slot
masks and the coherence scatter behind adaptive relhaplo; and
``ordered_sums``, under which every scatter sum of the port runs.
"""

from __future__ import annotations

import contextlib
import math

import torch

_MOVEHAPLO_TINY = math.exp(-400) * 5e-6 * 5e-6 * 0.5  # cnF2freq.cpp:3605


@contextlib.contextmanager
def ordered_sums():
    """Run ``index_add_`` and ``scatter_add_`` so that each bucket adds its
    terms in the order of the index, on every device.  On the card PyTorch
    adds them with atomics by default, in an order, and so with a
    rounding, that changes from run to run: the iteration's hit count,
    which steers the scalefactor, then varied between two runs of one
    input.  Its deterministic algorithms sort the index (a stable sort)
    and add each bucket's terms in turn, as the CPU does; the CPU's own
    sums are unchanged.  The mode is restored on exit."""
    if torch.are_deterministic_algorithms_enabled():
        yield
        return
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False, warn_only=warn_only)


def dup_masks(slot_ind: torch.Tensor):
    """slot_ind [B, S] -> (eq [B,S,S] same-individual mask, first [B,S]
    first-occurrence mask)."""
    occ = slot_ind > 0
    eq = (slot_ind[:, :, None] == slot_ind[:, None, :]) & occ[:, :, None] \
        & occ[:, None, :]
    S = slot_ind.shape[1]
    tri = torch.ones((S, S), dtype=torch.bool,
                     device=slot_ind.device).tril(-1)
    first = occ & ~(eq & tri[None]).any(dim=2)
    return eq, first


def scatter_coherence(slot_ind: torch.Tensor, descendants: torch.Tensor,
                      lo: int, coh: torch.Tensor, coh_num: torch.Tensor,
                      coh_den: torch.Tensor, lut: torch.Tensor) -> None:
    """coh [B, M, 7] adjacent-phase coherence -> descendant-weighted sums
    on the individuals' rows of coh_num / coh_den [NI, M_total] (in place,
    columns lo..lo+M); every occupied slot contributes, so a duplicate
    member adds twice.  lut maps an individual id to its row."""
    B, M, S = coh.shape
    NI = coh_num.shape[0]
    occupied = slot_ind > 0
    rows = torch.where(occupied, lut[slot_ind.long()], NI).reshape(B * S)
    desc = descendants.to(coh.dtype)[:, None, None]
    num = (desc * coh).transpose(1, 2).reshape(B * S, M)
    den = desc.expand(B, S, M).reshape(B * S, M)
    for acc, val in ((coh_num, num), (coh_den, den)):
        part = torch.zeros((NI + 1, M), dtype=acc.dtype, device=acc.device)
        with ordered_sums():
            part.index_add_(0, rows, val.to(acc.dtype))
        acc[:, lo:lo + M] += part[:NI]
