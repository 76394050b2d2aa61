"""Selfed-line model family: the SELFING state-space extension.

Port of ``cnf2freq_tpu/models/selfing.py``.  The reference's SELFING
build adds two state bits tracking whether the focal individual is
homozygous-by-descent (HBD) after repeated selfing: ``selfval`` 0 = the
ordinary F2 inheritance state, 1 / 2 = both strands copy one parental
strand, carried on interpretation slot 0 / 1 (3 is invalid), so the space
is ``3 * numtypes`` states.  The self axis is a tensor axis of size 3:
the base-state transition is the Walsh-Hadamard xor convolution and the
HBD transition a 3 x 3 coupling per unit and interval.  Emissions of the
two HBD states reuse the factored blocks with the focal's marker pair
replaced by the collapsed HBD pair (``root_override``).

This module keeps the JAX package's legacy [S, NS] layout (state second
minor) and is the second, independent route to the selfed-line
posterior beside ``engine_ext``; its sweeps run through
``ops.fb.fb_ext`` (csrc/fb_ext.cu on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MINFACTOR, SEXMARKER, UNKNOWN, ModelConfig, RuntimeParams
from ..hmm.emission import assemble_e_all, build_blocks
from ..hmm.family import FamilyBatch
from ..hmm.transition import interval_recomb, transition_eigenvalues
from ..ops.fb import fb_ext


def collapse_focal(md: torch.Tensor, ms: torch.Tensor):
    """The HBD-collapsed observed genotype.  md, ms: [B, M, 2] focal
    marker pair / error probabilities.  Returns (collapsed [B, M], csure
    [B, M], dead [B, M]): the single allele consistent with
    homozygosity-by-descent, its error probability, and the
    marker-is-impossible flag (heterozygous with a certain first
    allele)."""
    first, second = md[..., 0], md[..., 1]
    ms0, ms1 = ms[..., 0], ms[..., 1]
    bound = torch.where(first == UNKNOWN, second, first)
    miss = (first != UNKNOWN) \
        & ~((second == UNKNOWN) & (first != SEXMARKER)) \
        & (first != second)
    collapsed = torch.where(miss, second, bound)
    csure = torch.where(miss, 1.0 - ms0 * (1.0 - ms1),
                        1.0 - (1.0 - ms0) * (1.0 - ms1))
    dead = miss & (ms0 == 0)
    return collapsed, csure, dead


def hbd_overrides(md: torch.Tensor, ms: torch.Tensor):
    """(override for selfval 1, override for selfval 2, alive [B, M]):
    the root_override tuples of the two HBD statuses (the collapsed pair
    on interpretation slot 0 or 1; a selfing-collapsed root always
    canonicalises the interpretation) and the markers where the HBD
    hypothesis survives."""
    collapsed, csure, dead = collapse_focal(md, ms)
    unk = torch.zeros_like(collapsed)
    zero = torch.zeros_like(csure)
    coll_cond = torch.ones_like(collapsed, dtype=torch.bool)
    return ((collapsed, csure, unk, zero, coll_cond),
            (unk, zero, collapsed, csure, coll_cond), ~dead)


def selfing_emission(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                     dtype=torch.float64) -> torch.Tensor:
    """E[b, m, selfval(3), S, NS]: per-state emissions for all three HBD
    statuses (selfval 1/2 swap in the collapsed pair on interpretation
    slot 0/1)."""
    assert cfg.selfing

    def _sn(e):
        return e.transpose(-1, -2)

    e0 = _sn(assemble_e_all(build_blocks(fb, cfg, ci=ci, dtype=dtype), cfg))
    ov1, ov2, alive = hbd_overrides(fb.md[:, 0], fb.ms[:, 0])
    alive = alive[:, :, None, None].to(dtype)
    es = [e0]
    for ov in (ov1, ov2):
        blocks = build_blocks(fb, cfg, ci=ci, dtype=dtype, root_override=ov)
        es.append(_sn(assemble_e_all(blocks, cfg)) * alive)
    return torch.stack(es, dim=2)


def selfing_factors(selfgen: torch.Tensor,
                    dtype=torch.float64) -> torch.Tensor:
    """[B, 3] initial HBD-status distribution: P(not HBD) halves per
    selfing generation."""
    f0 = 0.5 ** selfgen.to(dtype)
    rest = (1.0 - f0) * 0.5
    return torch.stack([f0, rest, rest], dim=-1)


def selfprec_tensor(selfgen: torch.Tensor, dists: torch.Tensor, rate: float,
                    dtype=torch.float64) -> torch.Tensor:
    """[B, I, 3, 3] HBD-status transition factors per individual and
    marker interval; row = from, column = to."""
    sg = selfgen[:, None].to(dtype)
    r2 = 0.5 * (1.0 - torch.exp(sg * rate * dists.to(dtype)[None, :]))
    denom = torch.clamp(2.0 ** sg - 1.0, min=1.0)
    sp10 = torch.where(sg > 0, r2 * 2.0 / denom, torch.ones_like(r2))
    sp12 = sp10 * r2
    sp11 = 1.0 - sp10 - sp12
    row0 = torch.stack([1.0 - 2.0 * r2, r2, r2], dim=-1)
    row1 = torch.stack([sp10, sp11, sp12], dim=-1)
    row2 = torch.stack([sp10, sp12, sp11], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


class SelfingFBResult(NamedTuple):
    fw_pre: torch.Tensor    # [B, M, 3, S, NS]
    fw_post: torch.Tensor
    bw: torch.Tensor
    fw_pre_f: torch.Tensor  # [B, M, NS]
    fw_post_f: torch.Tensor
    bw_f: torch.Tensor

    @property
    def total_loglik(self) -> torch.Tensor:
        return self.fw_post_f[:, -1, :]


def selfing_forward_backward(e_self: torch.Tensor, dists: torch.Tensor,
                             selfgen: torch.Tensor, cfg: ModelConfig,
                             params: RuntimeParams) -> SelfingFBResult:
    """Sweeps over the extended (selfval, state) space; e_self
    [B, M, 3, S, NS], dists [M-1], selfgen [B].  The backward sweep
    applies the selfprec coupling in the forward orientation, as the
    reference does."""
    dtype = e_self.dtype
    lam = transition_eigenvalues(
        cfg, interval_recomb(cfg, params, dists)).to(dtype)
    sp = selfprec_tensor(selfgen, dists, params.genrec[2], dtype)
    prior = cfg.evengen * selfing_factors(selfgen, dtype)
    out = fb_ext(e_self.transpose(-1, -2).contiguous(), lam, sp, prior)
    sn = [x.transpose(-1, -2) for x in out[:3]]
    return SelfingFBResult(*sn, *out[3:])


def combined_loglik_self(fbres: SelfingFBResult,
                         shiftignore: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp of per-shift totals over allowed shift modes."""
    NS = fbres.fw_post_f.shape[-1]
    allowed = (torch.arange(NS, device=shiftignore.device)[None, :]
               & shiftignore[:, None]) == 0
    f = torch.where(allowed, fbres.total_loglik, MINFACTOR)
    fmax = f.max(dim=-1, keepdim=True).values
    return fmax[..., 0] + torch.log(torch.where(
        allowed, torch.exp(f - fmax), 0.0).sum(dim=-1))


def selfing_state_posterior(fbres: SelfingFBResult, total: torch.Tensor,
                            shiftignore: torch.Tensor) -> torch.Tensor:
    """P[b, m, selfval, g, s] posterior over the extended state space."""
    NS = fbres.fw_post_f.shape[-1]
    allowed = (torch.arange(NS, device=shiftignore.device)[None, :]
               & shiftignore[:, None]) == 0
    logw = fbres.fw_post_f + fbres.bw_f - total[:, None, None]
    w = torch.where(allowed[:, None, :], torch.exp(logw), 0.0)
    return fbres.fw_post * fbres.bw * w[:, :, None, None, :]


def hbd_posterior(post: torch.Tensor) -> torch.Tensor:
    """P(HBD)[b, m]: the marginal over selfval in {1, 2}."""
    return post[:, :, 1:].sum(dim=(2, 3, 4))


def selfing_scan(fb: FamilyBatch, dists: torch.Tensor, selfgen: torch.Tensor,
                 cfg: ModelConfig, params: RuntimeParams):
    """One full selfed-line chromosome pass: (total loglik [B], state
    posterior [B, M, 3, S, NS], P(HBD) [B, M])."""
    e = selfing_emission(fb, cfg, dtype=fb.ms.dtype)
    fbres = selfing_forward_backward(e, dists, selfgen, cfg, params)
    total = combined_loglik_self(fbres, fb.shiftignore)
    post = selfing_state_posterior(fbres, total, fb.shiftignore)
    norm = post.sum(dim=(2, 3, 4), keepdim=True)
    post = torch.where(norm > 0, post / torch.where(norm > 0, norm, 1.0),
                       0.0)
    return total, post, hbd_posterior(post)
