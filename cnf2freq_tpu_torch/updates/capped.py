"""Vectorized capped gradient steps (port of
``cnf2freq_tpu/updates/capped.py``).

Each bounded parameter moves along its gradient for a fixed pseudo-time:
find x with integral of 1/grad from the current value to x equal to the
global ``scalefactor`` (51-step bisection, 15-point Gauss-Legendre
quadrature), then cap the implied odds change at 3x.  All lanes step
together; the loop stops early once every lane is done (done lanes are
frozen, so the early stop is exact).  Unlike the JAX form, a lane whose
starting gradient is at the rounding floor stays where it is.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

_GL_X, _GL_W = np.polynomial.legendre.leggauss(15)
_CAP_ODDS = 3.0


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
    return torch.isfinite(g0) & \
        (g0.abs() > 1.0 / (1e-2 * torch.finfo(g0.dtype).eps ** 0.5))


def cappedgd(gradient: Callable[[torch.Tensor], torch.Tensor],
             orig: torch.Tensor, epsilon, scalefactor: float,
             breakathalf=False, iters: int = 51
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
