"""Posterior probe helpers (port of part of ``cnf2freq_tpu/hmm/probes.py``).

Only the haplotype update mask is on the main path; the update
statistics themselves come from ``ops.stats``.
"""

from __future__ import annotations

import torch

from cnf2freq_tpu.config import ModelConfig

from .family import FamilyBatch


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
