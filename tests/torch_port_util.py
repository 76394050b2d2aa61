"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Cohorts come from ``simulate_f2`` with a numpy seed; both packages get the
same numpy arrays.
"""

import dataclasses

import numpy as np
import torch

from cnf2freq_tpu.config import ModelConfig, RuntimeParams
from cnf2freq_tpu.utils.simulate import simulate_f2
from cnf2freq_tpu_torch.hmm.family import FamilyBatch, gather_family


def cohort(B=6, M=9, seed=3, with_vacant=False):
    """(ped, numpy FamilyBatch, dists, cfg, params) with randomised
    haploweights and error rates, as tests/test_scan_v2.py.  Imports no
    JAX (the card's tests use it too)."""
    ped = simulate_f2(n_f2=B, n_markers=M, n_founder_pairs=2, seed=seed)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    focals = list(ped.dous)
    if with_vacant:
        # F1 focals: founder parents, vacant grandparent slots
        focals += [i.n for i in ped.inds[1:]
                   if i.pars[0] and ped.by_id(i.pars[0]).founder][:2]
    fb = gather_family(ped, focals, 0, ped.num_markers - 1)
    rng = np.random.default_rng(seed)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    dists = np.diff(ped.markerposes).astype(np.float64)
    return ped, fb, dists, ModelConfig(), RuntimeParams()


def torch_batch(fb_np, dtype=torch.float64) -> FamilyBatch:
    """CPU tensors of a numpy batch."""
    return fb_np.to("cpu", dtype)


def jax_batch(fb_np):
    """The JAX package's FamilyBatch (jax arrays) of a numpy batch."""
    import jax.numpy as jnp

    from cnf2freq_tpu.hmm.family import FamilyBatch as JaxFamilyBatch
    return JaxFamilyBatch(**{f.name: getattr(fb_np, f.name, None)
                             for f in dataclasses.fields(JaxFamilyBatch)}
                          ).map(jnp.asarray)


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)
