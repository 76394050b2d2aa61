"""Accumulator-scatter helpers shared by the merges.

Port of the pieces of ``cnf2freq_tpu/updates/scatter.py`` that the
non-resident iteration uses: the movehaplos tiny term and the
duplicate-slot masks.
"""

from __future__ import annotations

import math

import torch

_MOVEHAPLO_TINY = math.exp(-400) * 5e-6 * 5e-6 * 0.5  # cnF2freq.cpp:3605


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
