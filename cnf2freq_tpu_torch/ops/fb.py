"""Forward and backward sweeps in the [B, M, NS, S] layout.

Port of ``cnf2freq_tpu/ops/fb_pallas.py`` (``fb_sweeps_pallas``), the
sweeps of the coherence-carrying scan.  ``fb_sweeps_reference`` is the
plain PyTorch twin, step for step the TPU kernels' arithmetic: carries
start at 1/S forward and at ones backward, values below 1e-30 are
clipped, the transition is H diag(lam) H / S, and the backward step from
marker m uses the interval lam[m - 1].  ``fb_sweeps`` is the wrapper: a
CPU tensor runs the twin; a CUDA tensor launches ``csrc/fb_classic.cu``
(which replaces ``fb_pallas._fwd_kernel`` and ``_bwd_kernel``) or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import MINFACTOR
from ..hmm.transition import fwht

ZERO_CLIP = 1e-30


def _step(p, f, e, lam_row):
    """Clip, emit, renormalise per (unit, shift), then the transition.
    p, e [B, NS, S]; f [B, NS].  Returns (post-emission p, f, next p)."""
    S = p.shape[-1]
    p = torch.where(p < ZERO_CLIP, 0.0, p)
    pe = p * e
    s = pe.sum(dim=-1, keepdim=True)
    ok = s > 0
    pn = torch.where(ok, pe / torch.where(ok, s, 1.0), 0.0)
    f = torch.where(ok[..., 0], f + torch.log(torch.where(ok[..., 0],
                                                          s[..., 0], 1.0)),
                    MINFACTOR)
    pnext = fwht(fwht(pn, -1) * lam_row, -1) / S
    return pn, f, pnext


def fb_sweeps_reference(e: torch.Tensor, lam: torch.Tensor):
    """Plain sweeps over e [B, M, NS, S] with lam [M-1, S] (a loop over
    the markers).  Returns (fw_pre, fw_post, bw [B, M, NS, S], fw_pre_f,
    fw_post_f, bw_f [B, M, NS])."""
    B, M, NS, S = e.shape
    kw = dict(dtype=e.dtype, device=e.device)
    lam_pad = torch.cat([lam.to(e.dtype), torch.ones((1, S), **kw)], dim=0)
    p = torch.full((B, NS, S), 1.0 / S, **kw)
    f = torch.zeros((B, NS), **kw)
    fw_pre, fw_pre_f, fw_post, fw_post_f = [], [], [], []
    for m in range(M):
        fw_pre.append(p)
        fw_pre_f.append(f)
        pn, f, p = _step(p, f, e[:, m], lam_pad[m])
        fw_post.append(pn)
        fw_post_f.append(f)
    p = torch.ones((B, NS, S), **kw)
    f = torch.zeros((B, NS), **kw)
    bw, bw_f = [None] * M, [None] * M
    for m in range(M - 1, -1, -1):
        bw[m], bw_f[m] = p, f
        if m > 0:
            _, f, p = _step(p, f, e[:, m], lam_pad[m - 1])

    def st(xs):
        return torch.stack(xs, dim=1)

    return (st(fw_pre), st(fw_post), st(bw), st(fw_pre_f), st(fw_post_f),
            st(bw_f))


def fb_sweeps(e: torch.Tensor, lam: torch.Tensor):
    """Both sweeps over e [B, M, NS, S]: ``fb_sweeps_reference`` on the
    CPU, csrc/fb_classic.cu on the card."""
    if e.device.type == "cpu":
        return fb_sweeps_reference(e, lam)
    B, M, NS, S = e.shape
    dt = e.dtype
    lam_pad = torch.cat([lam.to(dt), torch.ones((1, S), dtype=dt,
                                                device=e.device)],
                        dim=0).contiguous()
    _build.check(e, dt, (B, M, 8, 64), "e")
    _build.check(lam_pad, dt, (M, 64), "lam_pad")
    kw = dict(dtype=dt, device=e.device)
    out = tuple(torch.empty((B, M, 8, 64), **kw) for _ in range(3)) + \
        tuple(torch.empty((B, M, 8), **kw) for _ in range(3))
    _build.launch("fb_classic", dt, e, lam_pad, *out, B, M)
    fb_sweeps.launches += 1
    return out


fb_sweeps.launches = 0
