"""RELSKEWSTATES model family: phase coherence as an extra HMM state bit.

Port of ``cnf2freq_tpu/models/relskew_states.py``.  The reference's
RELSKEWSTATES build extends the hidden state with one bit that pins the
focal individual's root interpretation slot: the interpretation becomes
part of the state, and a switch between adjacent markers pays the
coherence factor ``relscore = (relhaplo, 1 - relhaplo)`` keyed on the
bit's xor.  The JAX module flattens the state to ``2 * numtypes`` and
diagonalises the whole transition by one 128-point Walsh-Hadamard
transform (the extra bit's eigenvalue ``2 relhaplo - 1``); the same
transition is the 64-state one times the 2 x 2 xor coupling
[[relh, 1 - relh], [1 - relh, relh]], which is how its sweeps run here:
through ``ops.fb.fb_ext`` (csrc/fb_ext.cu on the card), with the
outputs laid out as the JAX module's ([B, M, 2S, NS], state index
rel * S + base).  This module is the second, independent route to the
coherence-state posterior beside ``engine_ext``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import MINFACTOR, ModelConfig, RuntimeParams
from ..hmm.emission import assemble_e_all, build_blocks
from ..hmm.family import FamilyBatch
from ..hmm.transition import interval_recomb, transition_eigenvalues
from ..ops.fb import fb_ext
from ..utils.transfer import constant


def relstate_emission(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                      dtype=torch.float64) -> torch.Tensor:
    """E[b, m, rel(2), S, NS]: per-state emissions with the focal's root
    interpretation pinned to the coherence bit."""
    assert cfg.relskewstates
    blocks = build_blocks(fb, cfg, ci=ci, dtype=dtype)
    es = []
    for rel in range(2):
        mask = constant(np.arange(2) == rel, blocks.froot.device, dtype)
        pinned = blocks._replace(froot=blocks.froot * mask[:, None],
                                 top=blocks.top * mask[:, None])
        es.append(assemble_e_all(pinned, cfg).transpose(-1, -2))
    return torch.stack(es, dim=2)


def relstate_eigenvalues(cfg: ModelConfig, dists: torch.Tensor,
                         relh: torch.Tensor, params: RuntimeParams,
                         dtype=torch.float64) -> torch.Tensor:
    """what[b, interval, 2S]: WHT eigenvalues of the extended kernel,
    the base-bit factors times the coherence bit's ``2 relhaplo - 1``
    (state index rel * S + base).  relh: [B, M-1] at each interval's
    left marker."""
    lam = transition_eigenvalues(
        cfg, interval_recomb(cfg, params, dists)).to(dtype)   # [I, S]
    rel_eig = 2.0 * relh.to(dtype) - 1.0                      # [B, I]
    lo = lam[None] * torch.ones_like(rel_eig)[..., None]
    hi = lam[None] * rel_eig[..., None]
    return torch.cat([lo, hi], dim=-1)


def relstate_coupling(relh: torch.Tensor, dtype) -> torch.Tensor:
    """[B, I, 2, 2] the coherence bit's transition factors
    relscore[vf ^ vt] = (relh, 1 - relh) per interval; relh [B, I]."""
    same = relh.to(dtype)
    diff = 1.0 - same
    return torch.stack([torch.stack([same, diff], dim=-1),
                        torch.stack([diff, same], dim=-1)], dim=-2)


class RelFBResult(NamedTuple):
    fw_pre: torch.Tensor    # [B, M, 2S, NS]
    fw_post: torch.Tensor
    bw: torch.Tensor
    fw_pre_f: torch.Tensor  # [B, M, NS]
    fw_post_f: torch.Tensor
    bw_f: torch.Tensor

    @property
    def total_loglik(self) -> torch.Tensor:
        return self.fw_post_f[:, -1, :]


def relstate_forward_backward(e_rel: torch.Tensor, dists: torch.Tensor,
                              relh: torch.Tensor, cfg: ModelConfig,
                              params: RuntimeParams) -> RelFBResult:
    """Sweeps over the extended space; e_rel [B, M, 2, S, NS], relh
    [B, M-1]; the results flattened to [B, M, 2S, NS]."""
    B, M, _, S, NS = e_rel.shape
    dtype = e_rel.dtype
    lam = transition_eigenvalues(
        cfg, interval_recomb(cfg, params, dists)).to(dtype)
    prior = torch.full((B, 2), cfg.evengen, dtype=dtype,
                       device=e_rel.device)
    out = fb_ext(e_rel.transpose(-1, -2).contiguous(), lam,
                 relstate_coupling(relh, dtype), prior)
    flat = [x.transpose(-1, -2).reshape(B, M, 2 * S, NS) for x in out[:3]]
    return RelFBResult(*flat, *out[3:])


def combined_loglik_rel(fbres: RelFBResult,
                        shiftignore: torch.Tensor) -> torch.Tensor:
    NS = fbres.fw_post_f.shape[-1]
    allowed = (torch.arange(NS, device=shiftignore.device)[None, :]
               & shiftignore[:, None]) == 0
    f = torch.where(allowed, fbres.total_loglik, MINFACTOR)
    fmax = f.max(dim=-1, keepdim=True).values
    return fmax[..., 0] + torch.log(torch.where(
        allowed, torch.exp(f - fmax), 0.0).sum(dim=-1))


def relstate_scan(fb: FamilyBatch, dists: torch.Tensor, relh: torch.Tensor,
                  cfg: ModelConfig, params: RuntimeParams):
    """One full coherence-state chromosome pass: (total loglik [B],
    posterior [B, M, 2, S, NS], P(coherence bit = 1) [B, M])."""
    e = relstate_emission(fb, cfg, dtype=fb.ms.dtype)
    fbres = relstate_forward_backward(e, dists, relh, cfg, params)
    total = combined_loglik_rel(fbres, fb.shiftignore)
    NS = fbres.fw_post_f.shape[-1]
    allowed = (torch.arange(NS, device=fb.shiftignore.device)[None, :]
               & fb.shiftignore[:, None]) == 0
    logw = fbres.fw_post_f + fbres.bw_f - total[:, None, None]
    w = torch.where(allowed[:, None, :], torch.exp(logw), 0.0)
    post = fbres.fw_post * fbres.bw * w[:, :, None, :]
    B, M = post.shape[:2]
    S = post.shape[2] // 2
    post = post.reshape(B, M, 2, S, -1)
    norm = post.sum(dim=(2, 3, 4), keepdim=True)
    post = torch.where(norm > 0, post / torch.where(norm > 0, norm, 1.0),
                       0.0)
    return total, post, post[:, :, 1].sum(dim=(2, 3))
