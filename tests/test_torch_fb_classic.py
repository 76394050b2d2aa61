"""The port's [B, M, NS, S] kernels' plain twins against the JAX package.

* ``ops.fb.fb_sweeps_reference`` (twin of csrc/fb_classic.cu) against
  ``fb_sweeps_pallas`` in interpret mode: rtol 1e-12 / atol 1e-14 on the
  probabilities, rtol 1e-12 on the log factors (float64, summation order
  only); and through ``hmm.forward_backward`` against the JAX package's
  XLA scan (``use_pallas=False``, zero clip 1e-300 against the kernel's
  1e-30) at the tolerances of tests/test_pallas_fb.py.
* ``ops.stats.stats_bmns_reference`` (twin of the [B, M, NS, S] entry of
  csrc/stats.cu) against ``stats_pallas`` in interpret mode: rtol 1e-10.

Cohort: simulate_f2 with 5 units x 11 markers, which aligns neither with
the TPU kernels' batch tile nor with a warp; the JAX programs are compiled
once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
from torch_port_util import cohort, jax_batch, t, torch_batch

from cnf2freq_tpu.hmm.emission import assemble_e_all as jax_assemble_e_all
from cnf2freq_tpu.hmm.emission import build_blocks as jax_build_blocks
from cnf2freq_tpu.hmm.forward_backward import (combined_loglik as
                                               jax_combined_loglik)
from cnf2freq_tpu.hmm.forward_backward import (forward_backward as
                                               jax_forward_backward)
from cnf2freq_tpu.hmm.transition import (interval_recomb as jax_recomb,
                                         transition_eigenvalues as jax_eig)
from cnf2freq_tpu.ops.fb_pallas import fb_sweeps_pallas
from cnf2freq_tpu.ops.stats_pallas import stats_pallas as jax_stats_pallas
from cnf2freq_tpu_torch.hmm.forward_backward import (combined_loglik,
                                                     forward_backward)
from cnf2freq_tpu_torch.ops import fb as pfb
from cnf2freq_tpu_torch.ops import stats as pst

FB_NAMES = ("fw_pre", "fw_post", "bw", "fw_pre_f", "fw_post_f", "bw_f")
PROB = dict(rtol=1e-12, atol=1e-14)     # probabilities
FACT = dict(rtol=1e-12)                 # log factors


@functools.lru_cache(maxsize=None)
def _case():
    """(numpy cohort, JAX batch, e, lam, XLA-scan FBResult, total)."""
    _, fb, dists, cfg, params = cohort(B=5, M=11, seed=11)
    fbj = jax_batch(fb)
    e = jax.jit(lambda f: jax_assemble_e_all(
        jax_build_blocks(f, cfg, dtype=jnp.float64), cfg))(fbj)
    lam = jax_eig(cfg, jax_recomb(cfg, params, jnp.asarray(dists)))
    fbres = jax_forward_backward(e, jnp.asarray(dists), cfg, params,
                                 use_pallas=False)
    total = jax_combined_loglik(fbres, fbj.shiftignore)
    return (fb, dists, cfg, params), fbj, e, lam, fbres, total


def test_fb_twin_matches_pallas():
    _, _, e, lam, _, _ = _case()
    ref = fb_sweeps_pallas(e, lam, interpret=True)
    got = pfb.fb_sweeps(t(e), t(lam))
    for name, g, r in zip(FB_NAMES, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **(FACT if name.endswith("_f") else PROB))


def test_forward_backward_matches_xla_scan():
    (fb, dists, cfg, params), fbj, e, _, ref, total = _case()
    got = forward_backward(t(e), t(dists), cfg, params)
    for name in FB_NAMES:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name,
                                   **(FACT if name.endswith("_f") else PROB))
    np.testing.assert_allclose(
        combined_loglik(got, t(fb.shiftignore)).numpy(), np.asarray(total),
        rtol=1e-12)


def test_stats_bmns_twin_matches_pallas():
    (fb, _, cfg, _), fbj, _, _, fbres, total = _case()
    args = (fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, total)
    ref = jax_stats_pallas(fbj, *args, cfg, interpret=True)
    fbt = torch_batch(fb)
    got = pst.stats_pallas(fbt, *(t(a) for a in args), cfg)
    for name, g, r in zip(("b12", "accum", "pair"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10,
                                   err_msg=name)
    # slabs of two units fold into the same result
    slabs = pst.stats_bmns_reference(fbt, *(t(a) for a in args), cfg,
                                     max_pairs=2 * fb.md.shape[2])
    for a, b in zip(got, slabs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13)
