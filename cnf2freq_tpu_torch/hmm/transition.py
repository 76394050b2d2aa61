"""Transition model: recombination over (Z_2)^typebits.

An xor-kernel convolution diagonalises under the Walsh-Hadamard
transform, so one interval's transition is

    p' = H ( (H p) * what ) / S,   what[idx] = prod_t (1 - 2 r_t)^bit_t(idx)

with a shared Hadamard matrix H and per-interval eigenvalues ``what``.
Port of ``cnf2freq_tpu/hmm/transition.py``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import ModelConfig, RuntimeParams
from ..utils.transfer import constant


@lru_cache(maxsize=8)
def _hadamard_np(nbits: int) -> np.ndarray:
    h = np.array([[1.0]])
    one = np.array([[1.0, 1.0], [1.0, -1.0]])
    for _ in range(nbits):
        h = np.kron(h, one)
    return h


def hadamard(nbits: int, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Sylvester Hadamard matrix of order 2**nbits."""
    return torch.as_tensor(_hadamard_np(nbits), dtype=dtype, device=device)


def fwht(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unnormalised fast Walsh-Hadamard transform along ``dim`` (length a
    power of two): butterflies of stride 1, 2, 4, ... — the same
    arithmetic as the CUDA kernels' register butterflies, and no matrix
    product (so no TF32 rounding on the card)."""
    dim = dim % x.ndim
    n = x.shape[dim]
    pre, post = x.shape[:dim], x.shape[dim + 1:]
    h = 1
    while h < n:
        v = x.reshape(pre + (n // (2 * h), 2, h) + post)
        a = v.select(dim + 1, 0)
        b = v.select(dim + 1, 1)
        x = torch.stack([a + b, a - b], dim=dim + 1).reshape(
            pre + (n,) + post)
        h *= 2
    return x


def interval_recomb(cfg: ModelConfig, params: RuntimeParams,
                    dists: torch.Tensor, ratemat=None) -> torch.Tensor:
    """r[interval, typebits] = 0.5 (1 - exp(rate * dist))."""
    if ratemat is not None:
        rate = ratemat * dists[:, None]
    else:
        genrec = constant([params.genrec[g] for g in cfg.typegens],
                          dists.device, dists.dtype)
        rate = genrec[None, :] * dists[:, None]
    return 0.5 * (1.0 - torch.exp(rate))


def rate_matrix(cfg: ModelConfig, params: RuntimeParams, n_intervals: int,
                actrec=None, lo: int = 0, dtype=np.float64) -> np.ndarray:
    """Host-side per-interval per-bit rate matrix [n, typebits]: the
    per-generation base rates, or re-estimated per-sex rates ``actrec``
    stored at each interval's right marker."""
    if actrec is None:
        genrec = np.asarray([params.genrec[g] for g in cfg.typegens],
                            dtype=dtype)
        return np.broadcast_to(genrec[None, :],
                               (n_intervals, len(cfg.typegens))).copy()
    sexes = np.asarray(cfg.typesexes)
    return np.asarray(actrec, dtype=dtype)[sexes,
                                           lo + 1:lo + 1 + n_intervals].T


def transition_eigenvalues(cfg: ModelConfig, r: torch.Tensor) -> torch.Tensor:
    """WHT eigenvalues what[interval, S] of the xor transition kernel."""
    S = cfg.numtypes
    idx = torch.arange(S, device=r.device)
    bits = (idx[:, None] >> torch.arange(cfg.typebits,
                                         device=r.device)[None, :]) & 1
    lam = torch.where(bits[None, :, :] == 1, 1.0 - 2.0 * r[:, None, :],
                      torch.ones((), dtype=r.dtype, device=r.device))
    return lam.prod(dim=-1)


def apply_transition(probs: torch.Tensor, what: torch.Tensor) -> torch.Tensor:
    """probs [..., S] convolved with the kernel whose WHT is what [..., S]."""
    S = probs.shape[-1]
    return fwht(fwht(probs, -1) * what, -1) / S


def transition_matrix(cfg: ModelConfig, r_row: torch.Tensor) -> torch.Tensor:
    """Dense S x S matrix for one interval (reference-layout check path)."""
    S = cfg.numtypes
    idx = np.arange(S)
    xor = idx[:, None] ^ idx[None, :]
    bits = torch.as_tensor((xor[..., None] >> np.arange(cfg.typebits)) & 1,
                           device=r_row.device)
    return torch.where(bits == 1, r_row, 1.0 - r_row).prod(dim=-1)
