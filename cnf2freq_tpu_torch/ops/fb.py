"""Forward and backward sweeps in the [B, M, NS, S] layout.

Port of ``cnf2freq_tpu/ops/fb_pallas.py`` (``fb_sweeps_pallas``), the
sweeps of the coherence-carrying scan, and of the XLA ``lax.scan`` of
``cnf2freq_tpu/hmm/forward_backward.py`` that the JAX package runs for
the 4-state families.  ``fb_sweeps_reference`` is the plain PyTorch twin,
step for step the kernels' arithmetic: carries start at 1/S forward and
at ones backward, values below ``clip`` are zeroed (1e-30 as in the TPU
kernels; the 4-state engines pass the XLA scan's 1e-300, compared in the
tensor's dtype as JAX compares it, so in float32 it is 0 and nothing is
clipped), the transition is H diag(lam) H / S, and the backward step
from marker m uses the interval lam[m - 1].  ``fb_sweeps`` is the
wrapper: a CPU tensor runs the twin; a CUDA tensor launches, by its
(NS, S), ``csrc/fb_classic.cu`` for (8, 64) (which replaces
``fb_pallas._fwd_kernel`` and ``_bwd_kernel``) or ``csrc/fb_small.cu``
for (1, 4) and (2, 4) (which replaces the XLA scan), or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import MINFACTOR
from ..hmm.transition import fwht

ZERO_CLIP = 1e-30
# the XLA scan's clip (adjustprobs' 1e-300), which the 4-state engines use
XLA_CLIP = 1e-300
# (NS, S) of the 4-state entry's rows
SMALL_SHAPES = ((1, 4), (2, 4))


def _step(p, f, e, lam_row, clip=ZERO_CLIP):
    """Clip, emit, renormalise per (unit, shift), then the transition.
    p, e [B, NS, S]; f [B, NS].  Returns (post-emission p, f, next p).
    ``p < clip`` compares in p's dtype (a Python float takes the tensor's
    type), as JAX compares a weakly typed constant."""
    S = p.shape[-1]
    p = torch.where(p < clip, 0.0, p)
    pe = p * e
    s = pe.sum(dim=-1, keepdim=True)
    ok = s > 0
    pn = torch.where(ok, pe / torch.where(ok, s, 1.0), 0.0)
    f = torch.where(ok[..., 0], f + torch.log(torch.where(ok[..., 0],
                                                          s[..., 0], 1.0)),
                    MINFACTOR)
    pnext = fwht(fwht(pn, -1) * lam_row, -1) / S
    return pn, f, pnext


def fb_sweeps_reference(e: torch.Tensor, lam: torch.Tensor,
                        clip: float = ZERO_CLIP):
    """Plain sweeps over e [B, M, NS, S] with lam [M-1, S] (a loop over the
    markers), zeroing carried values below ``clip``.  Returns
    (fw_pre, fw_post, bw [B, M, NS, S], fw_pre_f, fw_post_f, bw_f
    [B, M, NS])."""
    B, M, NS, S = e.shape
    kw = dict(dtype=e.dtype, device=e.device)
    lam_pad = torch.cat([lam.to(e.dtype), torch.ones((1, S), **kw)], dim=0)
    p = torch.full((B, NS, S), 1.0 / S, **kw)
    f = torch.zeros((B, NS), **kw)
    fw_pre, fw_pre_f, fw_post, fw_post_f = [], [], [], []
    for m in range(M):
        fw_pre.append(p)
        fw_pre_f.append(f)
        pn, f, p = _step(p, f, e[:, m], lam_pad[m], clip)
        fw_post.append(pn)
        fw_post_f.append(f)
    p = torch.ones((B, NS, S), **kw)
    f = torch.zeros((B, NS), **kw)
    bw, bw_f = [None] * M, [None] * M
    for m in range(M - 1, -1, -1):
        bw[m], bw_f[m] = p, f
        if m > 0:
            _, f, p = _step(p, f, e[:, m], lam_pad[m - 1], clip)

    def st(xs):
        return torch.stack(xs, dim=1)

    return (st(fw_pre), st(fw_post), st(bw), st(fw_pre_f), st(fw_post_f),
            st(bw_f))


def fb_sweeps(e: torch.Tensor, lam: torch.Tensor, clip: float = ZERO_CLIP):
    """Both sweeps over e [B, M, NS, S]: ``fb_sweeps_reference`` on the
    CPU; on the card csrc/fb_classic.cu for (NS, S) = (8, 64) (whose clip
    is the TPU kernels' 1e-30) and csrc/fb_small.cu for the 4-state rows
    of SMALL_SHAPES (any clip, taken in e's dtype).  Any other shape on
    the card raises."""
    if e.device.type == "cpu":
        return fb_sweeps_reference(e, lam, clip)
    B, M, NS, S = e.shape
    dt = e.dtype
    if (NS, S) == (8, 64):
        if clip != ZERO_CLIP:
            raise ValueError(f"fb_classic clips at {ZERO_CLIP}, not {clip}")
        kernel, counter = "fb_classic", fb_sweeps
    elif (NS, S) in SMALL_SHAPES:
        kernel, counter = "fb_small", fb_sweeps_small
    else:
        raise ValueError(f"no sweep kernel for (NS, S) = ({NS}, {S}): the "
                         f"card runs (8, 64) and {SMALL_SHAPES}")
    lam_pad = torch.cat([lam.to(dt), torch.ones((1, S), dtype=dt,
                                                device=e.device)],
                        dim=0).contiguous()
    _build.check(e, dt, (B, M, NS, S), "e")
    _build.check(lam_pad, dt, (M, S), "lam_pad")
    kw = dict(dtype=dt, device=e.device)
    out = tuple(torch.empty((B, M, NS, S), **kw) for _ in range(3)) + \
        tuple(torch.empty((B, M, NS), **kw) for _ in range(3))
    if kernel == "fb_classic":
        _build.launch(kernel, dt, e, lam_pad, *out, B, M)
    else:
        _build.launch(kernel, dt, e, lam_pad, *out, B, M, NS, float(clip))
    counter.launches += 1
    return out


def fb_sweeps_small(e: torch.Tensor, lam: torch.Tensor,
                    clip: float = XLA_CLIP):
    """The 4-state entry alone: ``fb_sweeps`` for e [B, M, NS, 4] with
    NS in {1, 2}; its launches are counted here."""
    NS, S = e.shape[-2:]
    if (NS, S) not in SMALL_SHAPES:
        raise ValueError(f"fb_sweeps_small takes (NS, S) in {SMALL_SHAPES}, "
                         f"not ({NS}, {S})")
    return fb_sweeps(e, lam, clip)


fb_sweeps.launches = 0
fb_sweeps_small.launches = 0
