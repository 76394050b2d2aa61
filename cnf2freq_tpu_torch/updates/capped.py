"""Vectorized capped gradient steps (port of
``cnf2freq_tpu/updates/capped.py``).

Each bounded parameter moves along its gradient for a fixed pseudo-time:
find x with integral of 1/grad from the current value to x equal to the
global ``scalefactor`` (51-step bisection, 15-point Gauss-Legendre
quadrature), then cap the implied odds change at 3x.  All lanes step
together; the loop stops early once every lane is done (done lanes are
frozen, so the early stop is exact).  Unlike the JAX form, a lane whose
starting gradient is at the rounding floor stays where it is.

``cappedgd`` is the plain version over any gradient closure.  The two
lane-typed entries ``capped_haplo`` (haploweights) and ``capped_infprob``
(inferred genotypes) are the wrappers of ``csrc/capped.cu``: a CPU tensor
runs the entry's plain version (``capped_haplo_reference`` /
``capped_infprob_reference``: ``cappedgd`` with the entry's gradient
closure); a CUDA tensor launches the kernel (the whole bisection on the
card, its lanes one queue that the resident warps share through a counter
word of the launch's own, no host wait) and counts the launch, or raises.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .. import _build

_GL_X, _GL_W = np.polynomial.legendre.leggauss(15)
_CAP_ODDS = 3.0
# bisection steps at most
ITERS = 51


def caplogitchange(intended, orig, epsilon, breakathalf
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bound a proposed value so the odds change at most 3x.  Returns
    (value, hit), hit flagging a saturated move toward the boundary."""
    nnn = _CAP_ODDS
    limn = (nnn - 1.0) * orig * (orig - 1.0)
    limd1 = -1.0 - (nnn - 1.0) * orig
    limd2 = (nnn - 1.0) * orig - nnn

    intended = torch.minimum(torch.maximum(intended, epsilon), 1.0 - epsilon)
    diff = intended - orig
    hi = limn / limd1
    lo = -limn / limd2

    over = diff > hi
    under = diff < lo
    out = torch.where(over, orig + hi, torch.where(under, orig + lo,
                                                   intended))
    hit = (over & (out < 0.5)) | (under & (out > 0.5))

    flip = breakathalf & ((out - 0.5) * (orig - 0.5) < 0)
    out = torch.where(flip, 0.5 * (0.5 + orig), out)
    return out, hit


def flat_lanes(g0: torch.Tensor) -> torch.Tensor:
    """Lanes whose inverse gradient at the start, g0, says the gradient
    is at the rounding floor: a flat objective there (an unknown allele
    with symmetric evidence and no prior makes it flat everywhere).
    Integrating 1/noise would move such a lane by noise, so it stays."""
    return torch.isfinite(g0) & (g0.abs() > flat_limit(g0.dtype))


def flat_limit(dtype) -> float:
    """The bound on |1 / gradient| above which a lane is flat."""
    return 1.0 / (1e-2 * torch.finfo(dtype).eps ** 0.5)


def cappedgd(gradient: Callable[[torch.Tensor], torch.Tensor],
             orig: torch.Tensor, epsilon, scalefactor: float,
             breakathalf=False, iters: int = ITERS
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized cappedgd over [N] lanes.  gradient maps values [N] to
    gradients [N].  Returns (new_value, hit)."""
    dtype, dev = orig.dtype, orig.device

    def lanes(x, dt):
        # a Python scalar is filled in on the device (no host copy)
        if torch.is_tensor(x):
            return x.to(device=dev, dtype=dt).expand(orig.shape)
        return torch.full(orig.shape, x, dtype=dt, device=dev)

    epsilon = lanes(epsilon, dtype)
    breakathalf = lanes(breakathalf, torch.bool)
    sf = float(scalefactor)

    def clip(x):
        return torch.minimum(torch.maximum(x, epsilon), 1.0 - epsilon)

    def actualgradient(val):
        return 1.0 / gradient(clip(val))

    lolim, _ = caplogitchange(epsilon, orig, epsilon, breakathalf)
    hilim, _ = caplogitchange(1.0 - epsilon, orig, epsilon, breakathalf)
    lo0 = lolim - epsilon * 0.125
    hi0 = hilim + epsilon * 0.125
    origc, _ = caplogitchange(orig, orig, epsilon, breakathalf)

    g0 = actualgradient(origc)
    dead = ~torch.isfinite(g0) | flat_lanes(g0) | (sf == 0)
    lowside = g0 < 0
    lo = torch.where(dead, origc, torch.where(lowside, lo0, origc))
    hi = torch.where(dead, origc, torch.where(lowside, origc, hi0))

    gl_x = [float(x) for x in _GL_X]
    gl_w = [float(w) for w in _GL_W]

    def integrate(a, b):
        mid = 0.5 * (a + b)
        half = 0.5 * (b - a)
        acc = torch.zeros_like(mid)
        for x, w in zip(gl_x, gl_w):
            acc = acc + w / gradient(clip(mid + half * x))
        return acc * half

    done = dead
    if sf != 0.0:
        for _ in range(iters):
            if bool(done.all()):
                break
            done = done | (lo > hilim) | (hi < lolim)
            mid = 0.5 * (lo + hi)
            gv = actualgradient(mid)
            bad = ((gv < 0) ^ lowside) | ~torch.isfinite(gv)
            start = torch.minimum(origc, mid)
            end = torch.maximum(origc, mid)
            done = done | (((end - start) < 1e-10) & ~bad)
            prel = integrate(start, end)
            prel = torch.where(end != mid, -prel, prel)
            prel = torch.where(bad | ~torch.isfinite(prel),
                               (sf + 0.1) * 1.1, prel)
            done = done | ((prel - sf).abs() < sf * 1e-3)
            go_up = (prel < sf) ^ lowside
            lo = torch.where(done, lo, torch.where(go_up, mid, lo))
            hi = torch.where(done, hi, torch.where(go_up, hi, mid))
    return caplogitchange(0.5 * (lo + hi), orig, epsilon, breakathalf)


def pseudo_likelihood_grad(y, g, h, x):
    """The expanded gradient with (y, g, h) = (current probability,
    posterior-weighted count, total count)."""
    lx = torch.log(x)
    l1x = torch.log(1.0 - x)
    num = (-(y * g) ** 2 * lx + (y * g) ** 2 * l1x
           + y * y * g * h * lx - y * y * g * h * l1x - y * y * g * h
           - (y * h) ** 2 * x + (y * h) ** 2
           + y * g * g * lx - y * g * g * l1x + y * g * g
           + 2 * y * g * h * x - y * g * h * lx + y * g * h * l1x
           - y * g * h
           - g * g * x)
    den = (y * g + y * h * x - y * h - g * x) ** 2
    return -num / den


def haplo_gradient(w, B, C, sim, rel, desc, ef):
    """The haploweight lanes' gradient closure: the pseudo-likelihood term
    with (current weight, base, count), the entropy term damped by the
    similarity and the relskew pull weighted by the descendants."""
    def gradient(x):
        base = pseudo_likelihood_grad(w, B, C, x)
        ent = (1.0 - sim) * ef * torch.log(1.0 / x - 1.0)
        skew = (rel - x) / (x - x * x) * desc
        return base + ent + skew
    return gradient


def infprob_gradient(cp, a, t, prior, ef):
    """The genotype lanes' gradient closure: the pseudo-likelihood term
    with (current probability, allele mass, total mass), the entropy term
    and the prior's log odds."""
    def gradient(x):
        base = pseudo_likelihood_grad(cp, a, t, x)
        return base + ef * (torch.log(1.0 / x - 1.0) + prior)
    return gradient


def _step_scalars(sf: float, dtype):
    """The kernel's scalars after its lane pointers and counts: the
    scalefactor, the plain form's tolerance and bad-step substitute (both
    in double, as the plain form reckons them), the flat limit, whether
    every lane is frozen, and the steps."""
    sf = float(sf)
    return (sf, sf * 1e-3, (sf + 0.1) * 1.1, flat_limit(dtype),
            int(sf == 0.0), ITERS)


def _lane_counter(device) -> torch.Tensor:
    """The lane counter of one launch: a zeroed 64-bit word of its own,
    filled on the current stream, so that launches in flight at once on
    other streams take their lanes apart."""
    return torch.zeros(1, dtype=torch.int64, device=device)


def _lane_count(n: int) -> int:
    if n >= 2 ** 31:
        raise ValueError(f"{n} lanes: the kernel indexes lanes in 32 bits")
    return n


def capped_haplo_reference(w, B, C, sim, rel, desc, eps, brk, ef: float,
                           sf: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``capped_haplo``: ``cappedgd`` with
    ``haplo_gradient`` over the [N, M] lanes."""
    N, M = w.shape

    def lanes(x):
        return x.expand(N, M).reshape(-1)
    grad = haplo_gradient(lanes(w), lanes(B), lanes(C), lanes(sim),
                          lanes(rel), lanes(desc[:, None]), ef)
    v, h = cappedgd(grad, lanes(w), lanes(eps[:, None]), sf,
                    breakathalf=lanes(brk))
    return v.reshape(N, M), h.reshape(N, M)


def capped_haplo(w, B, C, sim, rel, desc, eps, brk, ef: float, sf: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capped step of the haploweight lanes: w, B, C, sim, rel and
    brk (bool, breakathalf) [N, M], desc and eps [N] per individual.
    Returns (new weights, hit) [N, M]: ``capped_haplo_reference`` on the
    CPU, ``csrc/capped.cu`` on the card."""
    if w.device.type == "cpu":
        return capped_haplo_reference(w, B, C, sim, rel, desc, eps, brk, ef,
                                      sf)
    N, M = w.shape
    dt = w.dtype
    w, B, C, sim, rel, desc, eps, brk = (
        x.contiguous() for x in (w, B, C, sim, rel, desc, eps, brk))
    for x, name in ((w, "w"), (B, "B"), (C, "C"), (sim, "sim"),
                    (rel, "rel")):
        _build.check(x, dt, (N, M), name)
    _build.check(desc, dt, (N,), "desc")
    _build.check(eps, dt, (N,), "eps")
    _build.check(brk, torch.bool, (N, M), "brk")
    out = torch.empty_like(w)
    hit = torch.empty((N, M), dtype=torch.bool, device=w.device)
    if w.numel():
        _build.launch("capped_haplo", dt, w, B, C, sim, rel, desc, eps, brk,
                      out, hit, _lane_counter(w.device),
                      _lane_count(w.numel()), M, float(ef),
                      *_step_scalars(sf, dt))
        capped_haplo.launches += 1
    return out, hit


def capped_infprob_reference(cp, a, t, prior, eps, ef: float, sf: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``capped_infprob``: ``cappedgd`` with
    ``infprob_gradient`` over every lane, then the lanes whose mass is not
    above 0 set to 0 and no hit."""
    shape = a.shape

    def lanes(x):
        return x.expand(shape).reshape(-1)
    grad = infprob_gradient(lanes(cp), lanes(a), lanes(t), lanes(prior), ef)
    v, h = cappedgd(grad, lanes(cp),
                    eps.reshape((-1,) + (1,) * (len(shape) - 1))
                    .expand(shape).reshape(-1), sf)
    live = a > 0
    return torch.where(live, v.reshape(shape), 0.0), h.reshape(shape) & live


def capped_infprob(cp, a, t, prior, eps, ef: float, sf: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capped step of the genotype lanes: cp (current probability), a
    (allele mass) and prior (log odds) [N, M, 2, 2], t (total mass)
    [N, M, 2, 1], eps [N] per individual.  A lane with a not above 0 is
    not updated: its value is 0 and it does not hit.  Returns (new
    probabilities, hit) [N, M, 2, 2]: ``capped_infprob_reference`` on the
    CPU, ``csrc/capped.cu`` on the card."""
    if a.device.type == "cpu":
        return capped_infprob_reference(cp, a, t, prior, eps, ef, sf)
    shape = a.shape
    N = shape[0]
    dt = a.dtype
    cp, a, t, prior, eps = (x.contiguous() for x in (cp, a, t, prior, eps))
    if shape[-1] != 2:
        raise ValueError(f"a: shape {tuple(shape)}, expected [..., 2]")
    _build.check(a, dt, shape, "a")
    _build.check(cp, dt, shape, "cp")
    _build.check(prior, dt, shape, "prior")
    _build.check(t, dt, tuple(shape[:-1]) + (1,), "t")
    _build.check(eps, dt, (N,), "eps")
    out = torch.empty_like(a)
    hit = torch.empty(shape, dtype=torch.bool, device=a.device)
    if a.numel():
        _build.launch("capped_infprob", dt, cp, a, t, prior, eps, out, hit,
                      _lane_counter(a.device), _lane_count(a.numel()),
                      a[0].numel(), float(ef),
                      *_step_scalars(sf, dt))
        capped_infprob.launches += 1
    return out, hit


capped_haplo.launches = 0
capped_infprob.launches = 0
