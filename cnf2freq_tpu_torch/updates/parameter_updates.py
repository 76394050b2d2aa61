"""Per-parameter update rules: haplotype weights and inferred genotypes
(port of ``cnf2freq_tpu/updates/parameter_updates.py``).

The shared analytic gradient is the derivative of the pseudo-likelihood

    ((h)(1-x) log(1-x) + g x log(x)) / (h (1-x) + g x)

after the substitutions of the reference's expanded expression.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RuntimeParams
from ..utils.transfer import constant

# pseudo_likelihood_grad (the shared gradient) is importable from here
from .capped import (capped_haplo, capped_infprob,  # noqa: F401
                     pseudo_likelihood_grad)


class HaploUpdateResult(NamedTuple):
    haploweight: torch.Tensor  # [N, M] updated weights
    hits: torch.Tensor         # [] saturated-step count


def update_haploweights(hw, haplobase, haplocount, markerdata, markersure,
                        relterm, descendants, children, lastinved_active,
                        active, params: RuntimeParams,
                        scalefactor: float) -> HaploUpdateResult:
    """Vectorized updatehaploweights over [N, M] lanes.

    relterm: relskew ratio per lane; descendants/children: [N];
    lastinved_active: [N] or [N, M] bool (breakathalf); active: [N, M]
    bool — lanes that update."""
    w = hw
    B0, C0 = haplobase, haplocount

    # similarity damping between near-duplicate allele observations
    scorea = 1.0 - markersure[..., 0]
    scoreb = torch.where(markerdata[..., 0] != markerdata[..., 1],
                         markersure[..., 1], 1.0 - markersure[..., 1])
    sim = scorea * scoreb + (1.0 - scorea) * (1.0 - scoreb)

    plain = (C0 == 0) | (sim == 1.0)
    C_plain = torch.clamp(C0, min=1.0)
    B_plain = w * C_plain

    simc = torch.clamp(sim, max=1.0 - params.maxdiff)
    count2 = C0 * (1.0 - simc)
    B_adj = (B0 - C0 * w + count2 * w) * \
        torch.where(count2 > 0, C0 / torch.where(count2 > 0, count2, 1.0),
                    0.0)
    B_adj = torch.minimum(torch.clamp(B_adj, min=0.0), C0)

    B = torch.where(plain, B_plain, B_adj)
    C = torch.where(plain, C_plain, C0)
    simeff = torch.where(plain, sim, simc)

    eps = params.maxdiff / (children.to(w.dtype) + 1.0)
    brk = lastinved_active if lastinved_active.dim() == 2 else \
        lastinved_active[:, None]
    newv, hit = capped_haplo(w, B, C, simeff, relterm,
                             descendants.to(w.dtype), eps,
                             brk.expand(w.shape), params.entropyfactor,
                             scalefactor)
    return HaploUpdateResult(haploweight=torch.where(active, newv, hw),
                             hits=(hit & active).sum())


class InfprobsUpdateResult(NamedTuple):
    newprob: torch.Tensor   # [N, M, 2(side), 2(allele 1/2)]
    hits: torch.Tensor


def update_infprobs(accum, markerdata, markersure, priordata, priorsure,
                    has_prior, children, params: RuntimeParams,
                    scalefactor: float) -> InfprobsUpdateResult:
    """Vectorized processinfprobs core: for each (individual, marker,
    side, candidate allele in {1,2}) move the current probability of that
    allele along the capped gradient.  Zero accum entries are skipped."""
    dtype = accum.dtype
    mv = constant([1, 2], accum.device)[None, None, None, :]
    cur = markerdata[..., None]                          # [N, M, 2, 1]
    sure = markersure[..., None]
    curprob = torch.where(cur == 0, 0.5,
                          ((cur == mv).to(dtype) - sure).abs())

    total = accum.sum(dim=-1, keepdim=True)

    pv = priordata[..., None]
    psure = priorsure[..., None]
    pprob = torch.where(pv == mv, 1.0 - psure, psure)
    pclip = torch.clamp(pprob, 1e-14, 1.0 - 1e-14)
    priord = torch.where(pprob == 0.0, -10000.0,
                         torch.where(pprob == 1.0, 10000.0,
                                     torch.log(pclip) -
                                     torch.log(1.0 - pclip)))
    priord = torch.where((pv != 0) & has_prior[:, None, None, None],
                         priord, 0.0)

    eps = params.maxdiff / (children.to(dtype) + 1.0)
    newprob, hit = capped_infprob(curprob, accum, total, priord, eps,
                                  params.entropyfactor, scalefactor)
    return InfprobsUpdateResult(newprob=newprob, hits=hit.sum())
