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

The families' marker-blocked scan (``blocked_families.py``) sweeps one
block at a time: ``fb_small_block`` / ``fb_ext_block`` both sweeps from
boundary carries (twins ``fb_block_reference`` /
``fb_ext_block_reference``, which with the whole-chromosome seeds are the
whole sweeps), ``fb_small_carry`` / ``fb_ext_carry`` one direction
carry-only (twins ``fb_carry_reference`` / ``fb_ext_carry_reference``),
each launching its own entry of ``csrc/fb_small.cu`` /
``csrc/fb_ext.cu`` on a CUDA tensor and counting its launches.  The
backward carry is bw at a block's last marker; its step across the
block's lower boundary takes the interval below the block.
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
    S = e.shape[-1]
    return fb_block_reference(e, pad_lam(lam, e.dtype, S),
                              *seed_carry(e, 1.0 / S),
                              *seed_carry(e, 1.0), clip)


def pad_lam(lam: torch.Tensor, dtype, S: int) -> torch.Tensor:
    """lam [M-1, S] with a row of ones appended: row m is the interval
    leaving marker m, the identity after the last."""
    return torch.cat([lam.to(dtype), torch.ones((1, S), dtype=dtype,
                                                device=lam.device)], dim=0)


def seed_carry(e: torch.Tensor, value: float):
    """A whole-chromosome carry seed for e [B, M, ..., NS, S]: (p full of
    ``value`` in the carry's shape e[:, 0], f [B, NS] zeros)."""
    kw = dict(dtype=e.dtype, device=e.device)
    return (torch.full(e[:, 0].shape, value, **kw),
            torch.zeros((e.shape[0], e.shape[-2]), **kw))


def fb_block_reference(e: torch.Tensor, lam_pad: torch.Tensor, p0, f0, bT,
                       bfT, clip: float = ZERO_CLIP):
    """Plain sweeps over one block e [B, K, NS, S] from boundary carries:
    the forward from (p0 [B, NS, S], f0 [B, NS]) entering the block, the
    backward from (bT, bfT), bw at the block's last marker; lam_pad
    [K, S] row j is the interval leaving marker j (the last row crosses
    the block's upper boundary, or is ones at the chromosome's end).  With
    ``seed_carry`` and the whole chromosome's padded eigenvalues this is
    the whole sweep; with a block's carries it is exactly that sweep's
    slice of the block.  Returns the six stores of
    ``fb_sweeps_reference``."""
    K = e.shape[1]
    p, f = p0, f0
    fw_pre, fw_pre_f, fw_post, fw_post_f = [], [], [], []
    for m in range(K):
        fw_pre.append(p)
        fw_pre_f.append(f)
        pn, f, p = _step(p, f, e[:, m], lam_pad[m], clip)
        fw_post.append(pn)
        fw_post_f.append(f)
    p, f = bT, bfT
    bw, bw_f = [None] * K, [None] * K
    for m in range(K - 1, -1, -1):
        bw[m], bw_f[m] = p, f
        if m > 0:
            _, f, p = _step(p, f, e[:, m], lam_pad[m - 1], clip)

    def st(xs):
        return torch.stack(xs, dim=1)

    return (st(fw_pre), st(fw_post), st(bw), st(fw_pre_f), st(fw_post_f),
            st(bw_f))


def fb_carry_reference(e: torch.Tensor, lam_pad: torch.Tensor, p, f,
                       clip: float = ZERO_CLIP, backward: bool = False,
                       lam_below=None):
    """Plain carry-only sweep over one block e [B, K, NS, S]: forward from
    the carry (p, f) entering the block, it returns the carry entering
    the next; backward from bw at the block's last marker, it consumes
    markers K-1..0 (the step at marker 0 crosses the boundary below
    through lam_below [S]) and returns bw at the previous block's last
    marker."""
    K = e.shape[1]
    if backward:
        for m in range(K - 1, -1, -1):
            _, f, p = _step(p, f, e[:, m],
                            lam_pad[m - 1] if m > 0 else lam_below, clip)
    else:
        for m in range(K):
            _, f, p = _step(p, f, e[:, m], lam_pad[m], clip)
    return p, f


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
    lam_pad = pad_lam(lam, dt, S).contiguous()
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


def _check_small(e: torch.Tensor, lam_pad: torch.Tensor):
    """(B, K, NS) of a 4-state block on the card; raises on what the
    4-state entries do not take."""
    B, K, NS, S = e.shape
    if (NS, S) not in SMALL_SHAPES:
        raise ValueError(f"the 4-state entries take (NS, S) in "
                         f"{SMALL_SHAPES}, not ({NS}, {S})")
    _build.check(e, e.dtype, (B, K, NS, S), "e")
    _build.check(lam_pad, e.dtype, (K, S), "lam_pad")
    return B, K, NS


def _check_carry(carry, shape, dt, name: str):
    if carry is not None:
        _build.check(carry[0], dt, shape, name + "[0]")
        _build.check(carry[1], dt, (shape[0], shape[-2]), name + "[1]")


def fb_small_block(e: torch.Tensor, lam_pad: torch.Tensor, init_fwd=None,
                   init_bwd=None, clip: float = XLA_CLIP):
    """Both 4-state sweeps over one block e [B, K, NS, 4] from boundary
    carries (pass C of the families' marker-blocked scan):
    ``fb_block_reference`` on the CPU, the seeded entry of
    csrc/fb_small.cu on the card.  ``init_fwd`` = (p [B, NS, 4], f
    [B, NS]) enters the block, ``init_bwd`` is bw at its last marker; None
    is the whole-chromosome seed (1/4 forward, ones backward)."""
    S = e.shape[-1]
    fwd = init_fwd or seed_carry(e, 1.0 / S)
    bwd = init_bwd or seed_carry(e, 1.0)
    if e.device.type == "cpu":
        return fb_block_reference(e, lam_pad.to(e.dtype), *fwd, *bwd, clip)
    B, K, NS = _check_small(e, lam_pad)
    dt = e.dtype
    for carry, name in ((fwd, "init_fwd"), (bwd, "init_bwd")):
        _check_carry(carry, (B, NS, S), dt, name)
    kw = dict(dtype=dt, device=e.device)
    out = tuple(torch.empty((B, K, NS, S), **kw) for _ in range(3)) + \
        tuple(torch.empty((B, K, NS), **kw) for _ in range(3))
    _build.launch("fb_small_init", dt, e, lam_pad, *fwd, *bwd, *out, B, K,
                  NS, float(clip))
    fb_small_block.launches += 1
    return out


def fb_small_carry(e: torch.Tensor, lam_pad: torch.Tensor, init=None,
                   clip: float = XLA_CLIP, backward: bool = False,
                   lam_below=None):
    """Carry-only 4-state sweep over one block (passes A and B):
    ``fb_carry_reference`` on the CPU, the carry-only entry of
    csrc/fb_small.cu on the card, which stores no [B, K, NS, 4] tensor.
    ``init`` = (p, f) entering the block (None: the whole-chromosome
    seed); ``lam_below`` [4] is the backward step's interval below the
    block (None: the identity).  Returns the outgoing (p [B, NS, 4],
    f [B, NS])."""
    S = e.shape[-1]
    p, f = init or seed_carry(e, 1.0 if backward else 1.0 / S)
    if lam_below is None:
        lam_below = torch.ones(S, dtype=e.dtype, device=e.device)
    if e.device.type == "cpu":
        return fb_carry_reference(e, lam_pad.to(e.dtype), p, f, clip,
                                  backward, lam_below.to(e.dtype))
    B, K, NS = _check_small(e, lam_pad)
    dt = e.dtype
    _check_carry((p, f), (B, NS, S), dt, "init")
    _build.check(lam_below, dt, (S,), "lam_below")
    p_out, f_out = torch.empty_like(p), torch.empty_like(f)
    _build.launch("fb_small_carry", dt, e, lam_pad, lam_below, p, f, p_out,
                  f_out, int(backward), B, K, NS, float(clip))
    fb_small_carry.launches += 1
    return p_out, f_out


fb_small_block.launches = 0
fb_small_carry.launches = 0


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
    return fb_ext_block_reference(
        e, pad_lam(lam, e.dtype, e.shape[-1]), pad_coupling(C, e.dtype),
        *ext_prior_seed(e, prior), *seed_carry(e, 1.0), clip)


def pad_coupling(C: torch.Tensor, dtype) -> torch.Tensor:
    """C [B, M-1, V, V] with the identity appended at the last marker."""
    B, _, V, _ = C.shape
    eye = torch.eye(V, dtype=dtype, device=C.device).expand(B, 1, V, V)
    return torch.cat([C.to(dtype), eye], dim=1)


def ext_prior_seed(e: torch.Tensor, prior: torch.Tensor):
    """The extended forward seed: (prior [B, V] in every shift and state
    as a [B, V, NS, S] carry, f [B, NS] zeros)."""
    p = prior.to(e.dtype)[:, :, None, None].expand(e[:, 0].shape)
    return p.contiguous(), seed_carry(e, 0.0)[1]


def fb_ext_block_reference(e: torch.Tensor, lam_pad: torch.Tensor,
                           C_pad: torch.Tensor, p0, f0, bT, bfT,
                           clip: float = XLA_CLIP):
    """Plain extended sweeps over one block e [B, K, V, NS, S] from
    boundary carries p0, bT [B, V, NS, S] and f0, bfT [B, NS] (the forward
    entering the block, bw at its last marker), with lam_pad [K, S] and
    C_pad [B, K, V, V] (row j: the interval leaving marker j; the last
    crosses the block's upper boundary, or is ones and the identity at
    the chromosome's end).  With ``ext_prior_seed``, ``seed_carry`` and
    the whole chromosome's padded intervals this is ``fb_ext_reference``;
    with a block's carries it is exactly that sweep's slice."""
    K = e.shape[1]
    p, f = p0, f0
    fw_pre, fw_pre_f, fw_post, fw_post_f = [], [], [], []
    for m in range(K):
        fw_pre.append(p)
        fw_pre_f.append(f)
        pn, f, p = _ext_step(p, f, e[:, m], lam_pad[m], C_pad[:, m], clip)
        fw_post.append(pn)
        fw_post_f.append(f)
    p, f = bT, bfT
    bw, bw_f = [None] * K, [None] * K
    for m in range(K - 1, -1, -1):
        bw[m], bw_f[m] = p, f
        if m > 0:
            _, f, p = _ext_step(p, f, e[:, m], lam_pad[m - 1],
                                C_pad[:, m - 1], clip)

    def st(xs):
        return torch.stack(xs, dim=1)

    return (st(fw_pre), st(fw_post), st(bw), st(fw_pre_f), st(fw_post_f),
            st(bw_f))


def fb_ext_carry_reference(e: torch.Tensor, lam_pad: torch.Tensor,
                           C_pad: torch.Tensor, p, f,
                           clip: float = XLA_CLIP, backward: bool = False,
                           lam_below=None, C_below=None):
    """Plain carry-only extended sweep over one block: forward from the
    carry entering the block to the one entering the next; backward from
    bw at the block's last marker to bw at the previous block's last
    marker, the step at marker 0 crossing the boundary below through
    lam_below [S] and C_below [B, V, V] (the interval below the block,
    in the forward from -> to orientation)."""
    K = e.shape[1]
    if backward:
        for m in range(K - 1, -1, -1):
            lam_m, c_m = (lam_pad[m - 1], C_pad[:, m - 1]) if m > 0 else \
                (lam_below, C_below)
            _, f, p = _ext_step(p, f, e[:, m], lam_m, c_m, clip)
    else:
        for m in range(K):
            _, f, p = _ext_step(p, f, e[:, m], lam_pad[m], C_pad[:, m], clip)
    return p, f


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
    lam_pad = pad_lam(lam, dt, S).contiguous()
    C_pad = pad_coupling(C, dt).contiguous()
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


def _check_ext(e: torch.Tensor, lam_pad: torch.Tensor, C_pad: torch.Tensor):
    """(B, K, V, NS) of an extended block on the card; raises on what the
    extended entries do not take."""
    B, K, V, NS, S = e.shape
    if S != 64 or V not in (2, 3):
        raise ValueError(f"the extended entries run S = 64 and V in (2, 3), "
                         f"not V = {V}, S = {S}")
    _build.check(e, e.dtype, (B, K, V, NS, S), "e")
    _build.check(lam_pad, e.dtype, (K, S), "lam_pad")
    _build.check(C_pad, e.dtype, (B, K, V, V), "C_pad")
    return B, K, V, NS


def fb_ext_block(e: torch.Tensor, lam_pad: torch.Tensor, C_pad: torch.Tensor,
                 init_fwd, init_bwd=None, clip: float = XLA_CLIP):
    """Both extended sweeps over one block e [B, K, V, NS, 64] from
    boundary carries (pass C of the marker-blocked scan):
    ``fb_ext_block_reference`` on the CPU, the seeded entry of
    csrc/fb_ext.cu on the card.  ``init_fwd`` = (p [B, V, NS, 64],
    f [B, NS]) enters the block (``ext_prior_seed`` at the chromosome's
    start); ``init_bwd`` is bw at its last marker (None: ones)."""
    bwd = init_bwd or seed_carry(e, 1.0)
    if e.device.type == "cpu":
        return fb_ext_block_reference(e, lam_pad.to(e.dtype),
                                      C_pad.to(e.dtype), *init_fwd, *bwd,
                                      clip)
    B, K, V, NS = _check_ext(e, lam_pad, C_pad)
    dt = e.dtype
    for carry, name in ((init_fwd, "init_fwd"), (bwd, "init_bwd")):
        _check_carry(carry, (B, V, NS, 64), dt, name)
    kw = dict(dtype=dt, device=e.device)
    out = tuple(torch.empty((B, K, V, NS, 64), **kw) for _ in range(3)) + \
        tuple(torch.empty((B, K, NS), **kw) for _ in range(3))
    _build.launch("fb_ext_init", dt, e, lam_pad, C_pad, *init_fwd, *bwd,
                  *out, B, K, V, NS, float(clip))
    fb_ext_block.launches += 1
    return out


def fb_ext_carry(e: torch.Tensor, lam_pad: torch.Tensor, C_pad: torch.Tensor,
                 init, clip: float = XLA_CLIP, backward: bool = False,
                 lam_below=None, C_below=None):
    """Carry-only extended sweep over one block (passes A and B):
    ``fb_ext_carry_reference`` on the CPU, the carry-only entry of
    csrc/fb_ext.cu on the card, which reads e and C once and stores only
    the outgoing carry.  ``init`` = (p [B, V, NS, 64], f [B, NS]);
    backward, ``lam_below`` [64] and ``C_below`` [B, V, V] are the
    interval below the block (None: ones and the identity).  Returns the
    outgoing (p, f)."""
    B, K, V, NS, S = e.shape
    dt, dev = e.dtype, e.device
    if lam_below is None:
        lam_below = torch.ones(S, dtype=dt, device=dev)
    if C_below is None:
        C_below = torch.eye(V, dtype=dt, device=dev).expand(B, V, V)
    if e.device.type == "cpu":
        return fb_ext_carry_reference(e, lam_pad.to(dt), C_pad.to(dt),
                                      *init, clip, backward,
                                      lam_below.to(dt), C_below.to(dt))
    _check_ext(e, lam_pad, C_pad)
    C_below = C_below.contiguous()
    _check_carry(init, (B, V, NS, S), dt, "init")
    _build.check(lam_below, dt, (S,), "lam_below")
    _build.check(C_below, dt, (B, V, V), "C_below")
    p_out, f_out = torch.empty_like(init[0]), torch.empty_like(init[1])
    _build.launch("fb_ext_carry", dt, e, lam_pad, C_pad, lam_below, C_below,
                  *init, p_out, f_out, int(backward), B, K, V, NS,
                  float(clip))
    fb_ext_carry.launches += 1
    return p_out, f_out


fb_ext_block.launches = 0
fb_ext_carry.launches = 0
