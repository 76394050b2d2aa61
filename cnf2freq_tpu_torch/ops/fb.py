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

The extended state spaces (SELFING, RELSKEWSTATES) sweep [B, M, V, NS, S]
with a [V, V] coupling per unit and interval: ``fb_ext_reference`` is the
plain twin of the two XLA scans of
``cnf2freq_tpu/engine_ext.py::extended_forward_backward`` and ``fb_ext``
its wrapper, which launches ``csrc/fb_ext.cu`` on a CUDA tensor.
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


def emit_normalise_ext(p, e, f, clip: float = XLA_CLIP):
    """adjustprobs of the extended spaces: values below ``clip`` (in p's
    dtype) zeroed, times the emission, renormalised over the (V, state)
    axes jointly per shift, the log of the sum added to f (MINFACTOR on a
    zero sum).  p, e [..., V, NS, S]; f [..., NS].  Returns (p, f)."""
    p = torch.where(p < clip, 0.0, p)
    pe = p * e
    s = pe.sum(dim=(-3, -1), keepdim=True)               # [..., 1, NS, 1]
    ok = s > 0
    pn = torch.where(ok, pe / torch.where(ok, s, 1.0), 0.0)
    ok0, s0 = ok[..., 0, :, 0], s[..., 0, :, 0]
    f = torch.where(ok0, f + torch.log(torch.where(ok0, s0, 1.0)),
                    MINFACTOR)
    return pn, f


def _ext_step(p, f, e, lam_row, cm, clip):
    """One extended step: ``emit_normalise_ext``, the transition of every
    row, then the coupling mix out[g] = sum_f cm[f, g] in[f].
    p, e [B, V, NS, S]; f [B, NS]; cm [B, V, V].  Returns (post-emission
    p, f, next p)."""
    S = p.shape[-1]
    V = p.shape[1]
    pn, f = emit_normalise_ext(p, e, f, clip)
    pc = fwht(fwht(pn, -1) * lam_row, -1) / S
    pnext = sum(cm[:, fr, :, None, None] * pc[:, fr, None]
                for fr in range(V))
    return pn, f, pnext


def fb_ext_reference(e: torch.Tensor, lam: torch.Tensor, C: torch.Tensor,
                     prior: torch.Tensor, clip: float = XLA_CLIP):
    """Plain extended sweeps over e [B, M, V, NS, S] with lam [M-1, S],
    the coupling C [B, M-1, V, V] (row = from, column = to) and the
    forward carry's start prior [B, V] (uniform over shifts and states);
    values below ``clip`` (in e's dtype) are zeroed.  The backward step
    applies C in the forward sweep's from -> to orientation.  Returns
    (fw_pre, fw_post, bw [B, M, V, NS, S], fw_pre_f, fw_post_f, bw_f
    [B, M, NS])."""
    B, M, V, NS, S = e.shape
    kw = dict(dtype=e.dtype, device=e.device)
    lam = lam.to(e.dtype)
    p = prior.to(e.dtype)[:, :, None, None].expand(B, V, NS, S)
    f = torch.zeros((B, NS), **kw)
    eye = torch.eye(V, **kw).expand(B, V, V)
    fw_pre, fw_pre_f, fw_post, fw_post_f = [], [], [], []
    for m in range(M):
        fw_pre.append(p)
        fw_pre_f.append(f)
        if m + 1 < M:
            pn, f, p = _ext_step(p, f, e[:, m], lam[m], C[:, m], clip)
        else:
            pn, f, p = _ext_step(p, f, e[:, m], torch.ones(S, **kw), eye,
                                 clip)
        fw_post.append(pn)
        fw_post_f.append(f)
    p = torch.ones((B, V, NS, S), **kw)
    f = torch.zeros((B, NS), **kw)
    bw, bw_f = [None] * M, [None] * M
    for m in range(M - 1, -1, -1):
        bw[m], bw_f[m] = p, f
        if m > 0:
            _, f, p = _ext_step(p, f, e[:, m], lam[m - 1], C[:, m - 1], clip)

    def st(xs):
        return torch.stack(xs, dim=1)

    return (st(fw_pre), st(fw_post), st(bw), st(fw_pre_f), st(fw_post_f),
            st(bw_f))


def fb_ext(e: torch.Tensor, lam: torch.Tensor, C: torch.Tensor,
           prior: torch.Tensor, clip: float = XLA_CLIP):
    """Both extended sweeps: ``fb_ext_reference`` on the CPU; on the card
    csrc/fb_ext.cu for S = 64 and V in {2, 3} (any other shape raises),
    with lam padded by a row of ones and C by the identity."""
    if e.device.type == "cpu":
        return fb_ext_reference(e, lam, C, prior, clip)
    B, M, V, NS, S = e.shape
    if S != 64 or V not in (2, 3):
        raise ValueError(f"fb_ext runs S = 64 and V in (2, 3), not "
                         f"V = {V}, S = {S}")
    dt, dev = e.dtype, e.device
    lam_pad = torch.cat([lam.to(dt), torch.ones((1, S), dtype=dt,
                                                 device=dev)]).contiguous()
    C_pad = torch.cat([C.to(dt), torch.eye(V, dtype=dt, device=dev).expand(
        B, 1, V, V)], dim=1).contiguous()
    prior = prior.to(dt).contiguous()
    _build.check(e, dt, (B, M, V, NS, S), "e")
    _build.check(lam_pad, dt, (M, S), "lam_pad")
    _build.check(C_pad, dt, (B, M, V, V), "C_pad")
    _build.check(prior, dt, (B, V), "prior")
    kw = dict(dtype=dt, device=dev)
    out = tuple(torch.empty((B, M, V, NS, S), **kw) for _ in range(3)) + \
        tuple(torch.empty((B, M, NS), **kw) for _ in range(3))
    _build.launch("fb_ext", dt, e, lam_pad, C_pad, prior, *out, B, M, V, NS,
                  float(clip))
    fb_ext.launches += 1
    return out


fb_ext.launches = 0
