"""Posterior probes: update masks, turn weights and adjacent-marker phase
coherence.

Port of the parts of ``cnf2freq_tpu/hmm/probes.py`` that the scans run.
The update statistics themselves come from ``ops.stats``.  These are
plain XLA in the JAX package, so they are plain PyTorch here: the
Walsh-Hadamard products are butterflies (``transition.fwht``), and each
multi-operand einsum of the coherence emissions is written as pairwise
contractions, so that no [B, M, ...] intermediate is larger than the
[B, M, NS, S] result.

Conventions: the state axis g decomposes into (fp1, fp0) and the shift
axis s into (s2, s1, s0); parent-block path bits are summed with the
canonical masks of flag2ignore.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MINFACTOR, ModelConfig
from ..ops.scan import turn_offsets
from .emission import EmissionBlocks
from .family import FamilyBatch
from .forward_backward import FBResult
from .transition import apply_transition, fwht

# static indicator tables ----------------------------------------------------
_FP = np.arange(8)
_FPATH = np.arange(8)
_SK = np.arange(2)
_J = np.arange(2)

# parent phase bit: rp ^ p0 ^ sk  (rp = fpath bit0, p0 = fp bit0)
_IND_PARENT = (((_FPATH[None, :, None, None] & 1)
                ^ (_FP[:, None, None, None] & 1)
                ^ _SK[None, None, :, None]) == _J[None, None, None, :])
# grandparent j phase bit: rg_j ^ gb_j (fpath bit 1+j, fp bit 1+j)
_IND_GP = [((((_FPATH[None, :, None, None] >> (1 + j)) & 1)
             ^ ((_FP[:, None, None, None] >> (1 + j)) & 1))
            == _J[None, None, None, :]) & (_SK[None, None, :, None] >= 0)
           for j in range(2)]
# focal phase bit: r0 ^ s0
_R0 = np.arange(2)
_S0 = np.arange(2)
_IND_FOCAL = ((_R0[:, None, None] ^ _S0[None, :, None]) == _J[None, None, :])


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


def posterior_weight(fbres: FBResult, total: torch.Tensor,
                     shiftignore: torch.Tensor) -> torch.Tensor:
    """W[b, m, s, g]: the per-(shift, state) weight that multiplies E_f[g]
    to give the posterior of a (state, path, shift) probe."""
    NS = fbres.fw_pre_f.shape[-1]
    allowed = (torch.arange(NS, device=shiftignore.device)[None, :]
               & shiftignore[:, None]) == 0
    logw = fbres.fw_pre_f + fbres.bw_f - total[:, None, None]
    logw = torch.where(allowed[:, None, :], logw, MINFACTOR)
    return fbres.fw_pre * fbres.bw * torch.exp(logw)[..., None]


def _valid_paths(flag2ignore: torch.Tensor, k: int) -> torch.Tensor:
    """[b, fpath(8)] canonical-path mask for parent k's local path bits
    (flag2 bits 1+3k .. 3+3k)."""
    f2 = (flag2ignore[:, None] >> (1 + 3 * k)) & 7
    return (torch.arange(8, device=flag2ignore.device)[None, :] & f2) == 0


def turn_weights_fast(fbres: FBResult, fb: FamilyBatch,
                      cfg: ModelConfig) -> torch.Tensor:
    """Turn clause weights [B, M, T] from one joint Walsh-Hadamard
    xor-correlation over (shift, state):

        D[x] = sum_y fw'[y] * bw'[y ^ x],   x = shift*S + state,

    with fw' = fw_post * exp(fw_post_f - max), bw' = bw * exp(bw_f - max)
    (the per-(b, m) max factors cancel in the weight ratio against the
    no-flip turn); w[t] = (log D[x(t)] - log D[x(0)]) * descendants."""
    B, M, NS, S = fbres.fw_post.shape
    dtype = fbres.fw_post.dtype
    X = S * NS
    allowed = (torch.arange(NS, device=fb.shiftignore.device)[None, :]
               & fb.shiftignore[:, None]) == 0
    ff = torch.where(allowed[:, None, :], fbres.fw_post_f, -torch.inf)
    ffm = ff.max(dim=-1).values                            # [B, M]
    fexp = torch.where(allowed[:, None, :],
                       torch.exp(ff - ffm[..., None]), 0.0)
    bf = fbres.bw_f
    bexp = torch.exp(bf - bf.max(dim=-1).values[..., None])

    # joint index shift-major (s*S + g), matching the [.., NS, S] layout
    fwp = (fbres.fw_post * fexp[..., None]).reshape(B, M, X)
    bwp = (fbres.bw * bexp[..., None]).reshape(B, M, X)
    D = fwht(fwht(fwp, -1) * fwht(bwp, -1), -1) / X       # [B, M, X]

    idx = torch.as_tensor(turn_offsets(cfg), dtype=torch.long,
                          device=D.device)
    vals = D[..., idx]                                     # [B, M, T]
    tiny = torch.finfo(dtype).tiny
    logv = torch.log(torch.clamp(vals, min=tiny))
    ok = vals > 0
    w = torch.where(ok & ok[..., 0:1], logv - logv[..., 0:1], MINFACTOR)
    return w * fb.descendants.to(dtype)[:, None, None]


# ---------------------------------------------------------------------------
# Adjacent-marker phase coherence
# ---------------------------------------------------------------------------
def _branch_emission(froot: torch.Tensor, left: torch.Tensor,
                     right: torch.Tensor) -> torch.Tensor:
    """e[b, m, v, u, t, b', a] = sum_r froot[.., r, t] * left[.., r, a, u]
    * right[.., r, b', v], reshaped to [B, M, NS, S] (shift (v, u, t),
    state (b', a)).  froot [B, M, 2, 2]; left/right [B, M, 2, 8, 2].
    Pairwise: the root folds into the left branch (64 values per pair),
    then one outer product per r adds into the 512-value result."""
    B, M = froot.shape[:2]
    e = None
    for r in range(2):
        fl = froot[:, :, r, :, None, None] * left[:, :, r, None]  # [t,a,u]
        fl = fl.permute(0, 1, 4, 2, 3)                       # [u, t, a]
        rt = right[:, :, r].transpose(2, 3)                  # [v, b']
        term = fl[:, :, None, :, :, None, :] * \
            rt[:, :, :, None, None, :, None]                 # [v,u,t,b',a]
        e = term if e is None else e + term
    return e.reshape(B, M, 8, 64)


def _path_summed(blocks: EmissionBlocks, fb: FamilyBatch, k: int):
    """Parent block k with the canonical path mask applied and the path
    axis summed: [B, M, r0, fp, sk]."""
    V = _valid_paths(fb.flag2ignore, k).to(blocks.froot.dtype)
    return (blocks.pb[k] * V[:, None, None, None, :, None]).sum(dim=-2)


def _phase_parity_emission(blocks: EmissionBlocks, fb: FamilyBatch,
                           cfg: ModelConfig, slot: int) -> torch.Tensor:
    """E_par[b, m, s, g]: the parity-signed emission e_{j=0} - e_{j=1} of
    the given slot's phase-interpretation bit, summed over all other path
    freedom."""
    dtype = blocks.froot.dtype
    dev = blocks.froot.device
    froot = blocks.froot
    if slot == 0:
        parf = torch.as_tensor(_IND_FOCAL[..., 0].astype(np.int8)
                               - _IND_FOCAL[..., 1].astype(np.int8),
                               dtype=dtype, device=dev)       # [r, t]
        return _branch_emission(froot * parf, _path_summed(blocks, fb, 0),
                                _path_summed(blocks, fb, 1))
    k = 0 if slot < cfg.parent_slot(1) else 1
    local = slot - cfg.parent_slot(k)
    ind = _IND_PARENT if local == 0 else _IND_GP[local - 1]
    par = torch.as_tensor(ind[..., 0].astype(np.int8)
                          - ind[..., 1].astype(np.int8), dtype=dtype,
                          device=dev)                         # [f, p, s]
    V = _valid_paths(fb.flag2ignore, k).to(dtype)
    vpar = V[:, None, None, None, :, None] * par              # [B,1,1,f,p,s]
    ph = (blocks.pb[k] * vpar).sum(dim=-2)                    # [B,M,r,f,s]
    if k == 0:
        return _branch_emission(froot, ph, _path_summed(blocks, fb, 1))
    return _branch_emission(froot, _path_summed(blocks, fb, 0), ph)


def pair_chain(fbres: FBResult, e: torch.Tensor,
               lam: torch.Tensor) -> torch.Tensor:
    """<(fw_pre . e)[m], T_m ((e . bw)[m+1])> with shift-mode weights:
    the pairwise-joint contraction underlying coherence, for one signed
    emission tensor e [B, M, NS, S].  Returns [B, M-1]."""
    logw = fbres.fw_pre_f[:, :-1, :] + fbres.bw_f[:, 1:, :]
    logw = logw - logw.max(dim=-1, keepdim=True).values
    w = torch.exp(logw)                                  # [B, M-1, NS]
    x = fbres.fw_pre[:, :-1] * e[:, :-1]                 # [B,M-1,NS,S]
    xt = apply_transition(x, lam[:, None, :])
    y = e[:, 1:] * fbres.bw[:, 1:]
    return ((xt * y).sum(dim=-1) * w).sum(dim=-1)


def pair_coherence_from_parity(fbres: FBResult, e_par: torch.Tensor,
                               lam: torch.Tensor,
                               tot: torch.Tensor) -> torch.Tensor:
    """C[b, m] from the parity-signed emission e_par and the shared pair
    total ``tot`` = pair_chain(e_all): with corr = same - diff and
    tot = same + diff, C = same / tot = (tot + corr) / (2 tot).  The last
    column is 0.5 padding."""
    B = e_par.shape[0]
    corr = pair_chain(fbres, e_par, lam)
    ok = tot > 0
    c = torch.where(ok, 0.5 + 0.5 * corr / torch.where(ok, tot, 1.0), 0.5)
    pad = torch.full((B, 1), 0.5, dtype=e_par.dtype, device=e_par.device)
    return torch.cat([c, pad], dim=1)


def phase_pair_total(fbres: FBResult, blocks: EmissionBlocks,
                     fb: FamilyBatch, cfg: ModelConfig,
                     lam: torch.Tensor) -> torch.Tensor:
    """The slot-independent pair total: pair_chain over the plain
    path-summed emission (what every slot's joint sums to)."""
    e = _branch_emission(blocks.froot, _path_summed(blocks, fb, 0),
                         _path_summed(blocks, fb, 1))
    return pair_chain(fbres, e, lam)


def phase_coherence_slot(fbres: FBResult, blocks: EmissionBlocks,
                         fb: FamilyBatch, cfg: ModelConfig,
                         lam: torch.Tensor, slot: int,
                         tot: torch.Tensor = None) -> torch.Tensor:
    """C[b, m]: posterior P(phase bit of `slot` equal at markers m, m+1)
    from the pairwise joint fw_pre[m] * E_par[m] * T_m * E_par[m+1] *
    bw[m+1] per shift mode; the last column is 0.5 padding.  ``tot``
    optionally supplies the shared phase_pair_total."""
    if tot is None:
        tot = phase_pair_total(fbres, blocks, fb, cfg, lam)
    e_par = _phase_parity_emission(blocks, fb, cfg, slot)
    return pair_coherence_from_parity(fbres, e_par, lam, tot)


def phase_coherence(fbres: FBResult, blocks: EmissionBlocks,
                    fb: FamilyBatch, cfg: ModelConfig,
                    lam: torch.Tensor) -> torch.Tensor:
    """All-slot coherence [b, m, slot] (shared pair total), one slot's
    temporaries live at a time."""
    tot = phase_pair_total(fbres, blocks, fb, cfg, lam)
    cols = [phase_coherence_slot(fbres, blocks, fb, cfg, lam, slot, tot=tot)
            for slot in range(cfg.numslots)]
    return torch.stack(cols, dim=-1)
