"""Batched forward-backward sweeps in the [B, M, NS, S] layout.

Port of ``cnf2freq_tpu/hmm/forward_backward.py`` (``FBResult``,
``forward_backward``, ``combined_loglik``).  The sweeps themselves are
``ops.fb.fb_sweeps``: the plain twin for a CPU tensor, a CUDA kernel for
a CUDA tensor (``csrc/fb_classic.cu`` for the 64-state space,
``csrc/fb_small.cu`` for the 4-state families).  The port has no XLA
scan, so there is no ``use_pallas`` switch; the clip follows the route
the JAX package takes for the config: the TPU kernel's 1e-30 for the
64-state space, the XLA scan's 1e-300 for the numgen == 2 families, which
the JAX package always sweeps with that scan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MINFACTOR, ModelConfig, RuntimeParams
from ..ops.fb import XLA_CLIP, ZERO_CLIP, fb_sweeps
from .transition import interval_recomb, transition_eigenvalues


class FBResult(NamedTuple):
    fw_pre: torch.Tensor    # [B, M, NS, S] (state minor)
    fw_post: torch.Tensor   # [B, M, NS, S]
    bw: torch.Tensor        # [B, M, NS, S]
    fw_pre_f: torch.Tensor  # [B, M, NS] log normalisers
    fw_post_f: torch.Tensor
    bw_f: torch.Tensor

    @property
    def total_loglik(self) -> torch.Tensor:
        """Per (individual, shift) total log-likelihood."""
        return self.fw_post_f[:, -1, :]


def forward_backward(e_all: torch.Tensor, dists: torch.Tensor,
                     cfg: ModelConfig, params: RuntimeParams,
                     ratemat=None) -> FBResult:
    """e_all: [B, M, NS, S] emission tensors; dists: [M-1] interval cM;
    ratemat: optional [M-1, typebits] map rates."""
    r = interval_recomb(cfg, params, dists, ratemat=ratemat)
    lam = transition_eigenvalues(cfg, r).to(e_all.dtype)      # [M-1, S]
    clip = XLA_CLIP if cfg.numgen == 2 else ZERO_CLIP
    return FBResult(*fb_sweeps(e_all, lam, clip))


def combined_loglik(fb: FBResult, shiftignore: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp of the per-shift total likelihoods over the allowed
    shift modes: [B]."""
    NS = fb.fw_post_f.shape[-1]
    shifts = torch.arange(NS, device=shiftignore.device)
    allowed = (shifts[None, :] & shiftignore[:, None]) == 0
    f = torch.where(allowed, fb.total_loglik, MINFACTOR)
    fmax = f.max(dim=-1, keepdim=True).values
    return fmax[..., 0] + torch.log(torch.where(
        allowed, torch.exp(f - fmax), 0.0).sum(dim=-1))
