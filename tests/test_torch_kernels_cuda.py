"""The CUDA kernels of cnf2freq_tpu_torch/csrc against their plain PyTorch
versions, on the card (marker ``cuda``; skipped without a CUDA device).

Run on a machine with the card (tests/conftest.py imports JAX):
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda
Tolerances: float64 rtol=1e-9 (summation order only), float32 rtol=1e-3
(rounding compounded over the marker sweeps).  Turn weights are compared
above a cut, where they are log-ratios of xor-correlations still clear of
the transform's rounding floor, with an absolute slack added: in f32 the
log of the 512-point transform's worst relative rounding at the cut
(eps * 512 * e^5), in f64 1e-10.
"""
import numpy as np
import pytest
import torch
from torch_port_util import cohort, torch_batch

from cnf2freq_tpu_torch.hmm.emission import assemble_e_all, build_blocks
from cnf2freq_tpu_torch.hmm.forward_backward import FBResult, combined_loglik
from cnf2freq_tpu_torch.hmm.transition import (interval_recomb,
                                               transition_eigenvalues)
from cnf2freq_tpu_torch.ops import fb as pfb
from cnf2freq_tpu_torch.ops import scan as ps
from cnf2freq_tpu_torch.ops import stats as pst

pytestmark = pytest.mark.cuda
TOL = {torch.float64: dict(rtol=1e-9, atol=1e-12),
       torch.float32: dict(rtol=1e-3, atol=1e-5)}
TURN = {torch.float64: dict(cut=20.0, slack=1e-10),
        torch.float32: dict(cut=5.0, slack=9.1e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(card, dtype):
    _, fb, dists, cfg, params = cohort(B=37, M=11, seed=9, with_vacant=True)
    fbt = torch_batch(fb).to(card, dtype)
    B, _, M, _ = fbt.md.shape
    st = ps.prep_slots(fbt, dtype)
    d = torch.as_tensor(dists, dtype=dtype, device=card)
    return fbt, st, d, cfg, params, B, M


def _close(got, ref, dtype):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["emission", "fb_sweep", "stats", "turn",
                                    "fb_classic", "stats_bmns"])
def test_kernel_matches_plain(card, kernel, dtype):
    fbt, st, d, cfg, params, B, M = _inputs(card, dtype)
    if kernel in ("fb_classic", "stats_bmns"):
        _check_classic(kernel, fbt, d, cfg, params, dtype)
        return
    e = ps.emission(st, M, cfg)
    if kernel == "emission":
        _close([e], [ps.emission_reference(st, M, cfg)], dtype)
        return
    fb2 = ps.fb_sweeps(e, d, cfg, params)
    if kernel == "fb_sweep":
        _close(fb2, ps.fb_scan_v2(e, d, cfg, params), dtype)
        return
    if kernel == "stats":
        tot = ps.combined_loglik_v2(fb2, st.sh)
        args = (st, fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f, tot, B, cfg)
        _close(pst.stats(*args), pst.stats_reference(*args), dtype)
        return
    desc = fbt.descendants.to(dtype)
    got = ps.turn_weights(fb2, st.sh, desc, cfg, B).cpu().numpy()
    ref = ps.turn_weights_v2(fb2, st.sh, desc, cfg, B).cpu().numpy()
    cut, slack = TURN[dtype]["cut"], TURN[dtype]["slack"]
    keep = ref > -cut
    assert (got[~keep] <= -cut + 1.0).all()
    np.testing.assert_allclose(got[keep], ref[keep], rtol=TOL[dtype]["rtol"],
                               atol=TOL[dtype]["atol"] + slack)


def _check_classic(kernel, fbt, d, cfg, params, dtype):
    """The [B, M, NS, S] kernels of the coherence-carrying scan."""
    e = assemble_e_all(build_blocks(fbt, cfg, dtype=dtype), cfg)
    lam = transition_eigenvalues(cfg, interval_recomb(cfg, params, d))
    got = pfb.fb_sweeps(e, lam)
    if kernel == "fb_classic":
        _close(got, pfb.fb_sweeps_reference(e, lam), dtype)
        return
    fbres = FBResult(*got)
    tot = combined_loglik(fbres, fbt.shiftignore)
    args = (fbt, fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, tot, cfg)
    _close(pst.stats_pallas(*args), pst.stats_bmns_reference(*args), dtype)


def test_wrapper_counts_and_checks(card):
    fbt, st, d, cfg, params, B, M = _inputs(card, torch.float64)
    before = ps.emission.launches
    ps.emission(st, M, cfg)
    assert ps.emission.launches == before + 1
    with pytest.raises(ValueError):
        ps.emission(st._replace(ms=st.ms.transpose(2, 3)), M, cfg)
    e = assemble_e_all(build_blocks(fbt, cfg), cfg)
    lam = transition_eigenvalues(cfg, interval_recomb(cfg, params, d))
    before = pfb.fb_sweeps.launches
    pfb.fb_sweeps(e, lam)
    assert pfb.fb_sweeps.launches == before + 1
    with pytest.raises(ValueError):
        pfb.fb_sweeps(e.transpose(0, 1), lam)
