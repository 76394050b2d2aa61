"""Relative-skew smoothing HMM (port of ``cnf2freq_tpu/updates/relskew.py``).

A 2-state HMM per individual per chromosome over adjacent-marker phase
coherence: emissions are the haplotype weights, transitions the
``relhaplo`` coherence weights.  Its per-marker state-1 posterior feeds
the haploweight gradient as ``relskewterm``.

``relskew_ratio_reference`` is the plain version, one loop over markers
with all individuals on the batch axis; ``relskew_ratio`` is its wrapper,
which launches ``csrc/relskew.cu`` (one thread a row, both passes on the
card) on a CUDA tensor and counts the launch.
"""

from __future__ import annotations

import torch

from .. import _build


def _renorm(s):
    mass = s.sum(dim=-1, keepdim=True)
    return torch.where(mass < 1e-10, s * 1e20, s)


def _trans(s, r):
    return s * r[..., 0:1] + s.flip(-1) * r[..., 1:2]


def _forward(em, rh):
    N, M = em.shape[:2]
    s = torch.full((N, 2), 0.5, dtype=em.dtype, device=em.device)
    fw = []
    for m in range(M):
        s = s * em[:, m]
        fw.append(s)
        s = _trans(_renorm(s), rh[:, m])
    return torch.stack(fw, dim=1)                       # [N, M, 2]


def _inputs(hw, relhaplo):
    em = torch.stack([1.0 - hw, hw], dim=-1)             # [N, M, 2]
    rh = torch.stack([relhaplo, 1.0 - relhaplo], dim=-1)
    return em, rh


def relskew_ratio_reference(hw: torch.Tensor,
                            relhaplo: torch.Tensor) -> torch.Tensor:
    """ratio[n, m] = posterior of phase-state 1 at marker m; hw, relhaplo
    [N, M].  Forward pass (emission at m, then transition relhaplo[m])
    and an emission-inclusive backward pass that rescales only when the
    mass underflows 1e-10."""
    N, M = hw.shape
    em, rh = _inputs(hw, relhaplo)
    fw = _forward(em, rh)
    s = torch.full((N, 2), 0.5, dtype=hw.dtype, device=hw.device)
    rf = [None] * (M - 1)
    for m in range(M - 2, -1, -1):
        s = _renorm(_trans(s * em[:, m + 1], rh[:, m]))
        rf[m] = s * fw[:, m]
    last = fw[:, -1]
    ratios_last = (last[:, 1] / (last[:, 0] + last[:, 1]))[:, None]
    if M == 1:
        return ratios_last
    rf = torch.stack(rf, dim=1)                          # [N, M-1, 2]
    ratios = rf[..., 1] / (rf[..., 0] + rf[..., 1])
    return torch.cat([ratios, ratios_last], dim=1)


def _row_view(x: torch.Tensor, shape, dtype, name: str) -> None:
    """Raises unless x is a CUDA [N, M] tensor of ``dtype`` whose rows are
    contiguous (a column slice of a contiguous tensor is)."""
    if not torch.is_tensor(x) or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name}: its rows are not contiguous")
    if x.stride(0) >= 2 ** 31:
        raise ValueError(f"{name}: row stride {x.stride(0)} over 32 bits")


def relskew_ratio(hw: torch.Tensor, relhaplo: torch.Tensor) -> torch.Tensor:
    """``relskew_ratio_reference`` on the CPU; on the card
    ``csrc/relskew.cu``, which reads hw and relhaplo [N, M] in place
    through their row strides (so the columns of one chromosome need no
    copy)."""
    if hw.device.type == "cpu":
        return relskew_ratio_reference(hw, relhaplo)
    N, M = hw.shape
    dt = hw.dtype
    _row_view(hw, (N, M), dt, "hw")
    _row_view(relhaplo, (N, M), dt, "relhaplo")
    ratio = torch.empty((N, M), dtype=dt, device=hw.device)
    if N and M:
        fw = torch.empty((M, N, 2), dtype=dt, device=hw.device)
        _build.launch("relskew_ratio", dt, hw, relhaplo, fw, ratio, N, M,
                      hw.stride(0), relhaplo.stride(0))
        relskew_ratio.launches += 1
    return ratio


relskew_ratio.launches = 0


def relskew_weight(hw: torch.Tensor, relhaplo: torch.Tensor):
    """Normalised forward (w0) and backward (w1) state-1 weights [N, M];
    w1 at the first marker is 0.5."""
    N, M = hw.shape
    em, rh = _inputs(hw, relhaplo)
    fw = _forward(em, rh)
    s = torch.full((N, 2), 0.5, dtype=hw.dtype, device=hw.device)
    bw = [torch.full((N, 2), 0.5, dtype=hw.dtype, device=hw.device)] + \
        [None] * (M - 1)
    for m in range(M - 2, -1, -1):
        s = s * em[:, m + 1]
        bw[m + 1] = s
        s = _renorm(_trans(s, rh[:, m]))
    bw = torch.stack(bw, dim=1)
    w0 = fw[..., 1] / fw.sum(dim=-1)
    w1 = bw[..., 1] / bw.sum(dim=-1)
    return w0, w1
