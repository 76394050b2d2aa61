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

from .capped import cappedgd


def pseudo_likelihood_grad(y, g, h, x):
    """The expanded gradient with (y, g, h) = (current probability,
    posterior-weighted count, total count)."""
    lx = torch.log(x)
    l1x = torch.log(1.0 - x)
    num = (-(y * g) ** 2 * lx + (y * g) ** 2 * l1x
           + y * y * g * h * lx - y * y * g * h * l1x - y * y * g * h
           - (y * h) ** 2 * x + (y * h) ** 2
           + y * g * g * lx - y * g * g * l1x + y * g * g
           + 2 * y * g * h * x - y * g * h * lx + y * g * h * l1x
           - y * g * h
           - g * g * x)
    den = (y * g + y * h * x - y * h - g * x) ** 2
    return -num / den


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

    ef = params.entropyfactor
    desc = (descendants.to(w.dtype)[:, None] *
            torch.ones_like(w)).reshape(-1)
    wf, Bf, Cf = w.reshape(-1), B.reshape(-1), C.reshape(-1)
    simf, relf = simeff.reshape(-1), relterm.reshape(-1)

    def gradient(x):
        base = pseudo_likelihood_grad(wf, Bf, Cf, x)
        ent = (1.0 - simf) * ef * torch.log(1.0 / x - 1.0)
        rel = (relf - x) / (x - x * x) * desc
        return base + ent + rel

    eps = (params.maxdiff / (children.to(w.dtype)[:, None] + 1.0)) * \
        torch.ones_like(w)
    brk = lastinved_active if lastinved_active.dim() == 2 else \
        lastinved_active[:, None]
    newv, hit = cappedgd(gradient, wf, eps.reshape(-1), scalefactor,
                         breakathalf=brk.expand(w.shape).reshape(-1))
    newv = newv.reshape(w.shape)
    hit = hit.reshape(w.shape) & active
    return HaploUpdateResult(haploweight=torch.where(active, newv, hw),
                             hits=hit.sum())


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

    ef = params.entropyfactor
    shape = accum.shape
    cp = curprob.expand(shape).reshape(-1)
    af = accum.reshape(-1)
    tf = total.expand(shape).reshape(-1)
    pf = priord.expand(shape).reshape(-1)

    def gradient(x):
        base = pseudo_likelihood_grad(cp, af, tf, x)
        return base + ef * (torch.log(1.0 / x - 1.0) + pf)

    eps = (params.maxdiff /
           (children.to(dtype)[:, None, None, None] + 1.0)).expand(shape)
    newv, hit = cappedgd(gradient, cp, eps.reshape(-1), scalefactor)
    newv = newv.reshape(shape)
    live = accum > 0
    return InfprobsUpdateResult(newprob=torch.where(live, newv, 0.0),
                                hits=(hit.reshape(shape) & live).sum())
