"""Inputs of the update stage with its edge lanes, for the CPU tests of
the update kernels' entries against the JAX package
(tests/test_torch_update_kernels.py) and for their card tests against
the plain versions (tests/test_torch_kernels_cuda.py).  numpy only: the
card's machine has no JAX.

Each generator makes the raw arguments of an update function (the port's
and the JAX package's take the same ones) from a numpy seed, at random
but for a few rows that carry one edge each.
"""

import numpy as np

from cnf2freq_tpu_torch.config import RuntimeParams

MAXDIFF = RuntimeParams().maxdiff
# a weight or probability off 0.5 by a rounding-floor amount gives a flat
# lane (capped.flat_lanes): 1e-13 in float64; 6e-8 (haploweights) and 2e-7
# (genotypes) in float32, where 1e-13 rounds to 0.5 itself
FLAT_OFFSETS = (1e-13, 6e-8)
FLAT_OFFSETS_INFPROB = (1e-13, 2e-7)


def _genotypes(rng, N, M):
    md = rng.integers(0, 3, (N, M, 2)).astype(np.int32)
    ms = np.where(md > 0, rng.uniform(0.0, 0.3, (N, M, 2)), 0.0)
    return md, ms


def haplo_inputs(N=12, M=11, seed=2):
    """update_haploweights' arguments (hw, hb, hc, md, ms, rel, desc,
    children, lastinv, active), every lane active.  Rows: 0 weights at
    eps, 1 at 1 - eps; 2 and 3 flat (no count, neutral relskew, a weight
    off 0.5 by FLAT_OFFSETS); 4 a NaN relskew term (NaN gradients); 5 and
    6 breakathalf, weights beside 0.5 pulled across it."""
    rng = np.random.default_rng(seed)
    md, ms = _genotypes(rng, N, M)
    hw = rng.uniform(0.02, 0.98, (N, M))
    hc = rng.integers(0, 4, (N, M)).astype(float)
    hb = hc * rng.uniform(0, 1, (N, M))
    rel = rng.uniform(0.1, 0.9, (N, M))
    desc = rng.integers(1, 5, N).astype(float)
    children = rng.integers(0, 4, N).astype(float)
    lastinv = rng.random((N, M)) < 0.3
    eps = MAXDIFF / (children + 1.0)
    hw[0], hw[1] = eps[0], 1.0 - eps[1]
    hc[2:4], hb[2:4], rel[2:4] = 0.0, 0.0, 0.5
    hw[2], hw[3] = (0.5 + d for d in FLAT_OFFSETS)
    rel[4] = np.nan
    lastinv[5:7] = True
    hw[5], hw[6] = 0.49, 0.51
    hc[5:7] = 4.0
    hb[5], hb[6] = 4.0, 0.0
    active = np.ones((N, M), dtype=bool)
    return hw, hb, hc, md, ms, rel, desc, children, lastinv, active


def infprob_inputs(N=12, M=11, seed=3):
    """update_infprobs' arguments (accum, md, ms, prior, psure, has_prior,
    children).  Rows: 0 typed sides whose current probabilities sit at
    eps and 1 - eps; 1 and 2 flat (untyped sides, no prior, allele masses
    equal but for FLAT_OFFSETS_INFPROB); 3 a NaN mass on allele 1, so the
    allele-2 lanes' total, and gradient, is NaN; 4 no mass at all; and
    about a fifth of the other lanes without mass."""
    rng = np.random.default_rng(seed)
    md, ms = _genotypes(rng, N, M)
    prior, psure = _genotypes(rng, N, M)
    accum = rng.uniform(0, 2, (N, M, 2, 2))
    accum[rng.random((N, M, 2, 2)) < 0.2] = 0.0
    has_prior = rng.random(N) < 0.8
    children = rng.integers(0, 4, N).astype(float)
    eps = MAXDIFF / (children + 1.0)
    md[0] = rng.integers(1, 3, (M, 2))
    ms[0] = eps[0]
    for row, d in zip((1, 2), FLAT_OFFSETS_INFPROB):
        md[row], ms[row], has_prior[row] = 0, 0.0, False
        accum[row, ..., 0], accum[row, ..., 1] = 1.0 + d, 1.0
    accum[3, ..., 0], accum[3, ..., 1] = np.nan, 1.0
    accum[4] = 0.0
    return accum, md, ms, prior, psure, has_prior, children


def relskew_inputs(N=7, M=11, seed=4):
    """relskew_ratio's (hw, relhaplo) [N, M].  Rows 0 and 1 alternate
    weights 1e-6 and 1 - 1e-6 under relhaplo 1 - 1e-6, so that the mass of
    both passes falls below 1e-10 and is rescaled; some first weights are
    0."""
    rng = np.random.default_rng(seed)
    hw = rng.uniform(0.0, 1.0, (N, M))
    hw[:, 0] = np.where(rng.random(N) < 0.3, 0.0, hw[:, 0])
    rh = rng.uniform(1e-4, 1 - 1e-4, (N, M))
    alt = np.where(np.arange(M) % 2 == 0, 1e-6, 1 - 1e-6)
    hw[0], hw[1] = alt, 1.0 - alt
    rh[0:2] = 1 - 1e-6
    return hw, rh


def forward_rescales(hw, rh):
    """Rows of relskew_ratio's forward pass whose mass falls below 1e-10
    before the transition at some marker (relskew._renorm rescales
    there)."""
    N, M = hw.shape
    s = np.full((N, 2), 0.5)
    hit = np.zeros(N, dtype=bool)
    for m in range(M):
        s = s * np.stack([1.0 - hw[:, m], hw[:, m]], axis=-1)
        low = s.sum(axis=-1) < 1e-10
        hit |= low
        s = np.where(low[:, None], s * 1e20, s)
        r = np.stack([rh[:, m], 1.0 - rh[:, m]], axis=-1)
        s = s * r[:, :1] + s[:, ::-1] * r[:, 1:]
    return hit
