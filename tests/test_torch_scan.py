"""The port's scan stages (cnf2freq_tpu_torch/ops) against the JAX package.

Each plain PyTorch twin of a CUDA kernel is held against the JAX function
whose Pallas kernel it replaces, run in interpret mode on the CPU, on the
same numpy inputs (B~6, M~9 simulate_f2 cohorts, float64): emission vs
emission_tiles, sweeps vs fb_sweeps_v2_pallas, statistics vs
stats_from_v2, turn weights vs turn_weights_v2_pallas, and the whole scan
vs engine.chromosome_scan(use_scan_v2=True).  Tolerance rtol=1e-9 in f64
(summation order differs); the f32 case is held at rtol=1e-4, atol=1e-6.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import cohort, jax_batch, t, torch_batch

from cnf2freq_tpu.engine import chromosome_scan as jax_chromosome_scan
from cnf2freq_tpu.ops import scan_v2 as v2
from cnf2freq_tpu_torch.engine import chromosome_scan
from cnf2freq_tpu_torch.hmm.family import gather_family
from cnf2freq_tpu_torch.ops import scan as ps
from cnf2freq_tpu_torch.ops import stats as pst

RTOL, ATOL = 1e-9, 1e-12


@functools.lru_cache(maxsize=None)
def _case(dtype=jnp.float64, **kw):
    """(cohort, JAX pipeline) for one cohort, shared across tests."""
    ped, fb, dists, cfg, params = cohort(**kw)
    return (fb, dists, cfg, params), _jax_pipeline(fb, dists, cfg, params,
                                                   dtype)


def _jax_pipeline(fb, dists, cfg, params, dtype=jnp.float64):
    fbj = jax_batch(fb)
    if dtype == jnp.float32:
        fbj = fbj.map(lambda x: x.astype(jnp.float32)
                      if x.dtype == jnp.float64 else x)
    M = fbj.md.shape[2]
    st = v2.prep_slots(fbj, dtype)
    R = st.nb * 8 * 128
    e = v2.emission_tiles(st, M, cfg, dtype=dtype,
                          interpret=True).reshape(M, 512, R)
    fb2 = v2.fb_sweeps_v2_pallas(e, jnp.asarray(dists, dtype=dtype), cfg,
                                 params, interpret=True)
    return fbj, st, e, fb2


def _port_slots(st, M):
    """The port's SlotTensors holding the JAX prep_slots arrays."""
    R = st.nb * 8 * 128
    return ps.SlotTensors(
        md=t(st.md).reshape(7, 2, M, R), ms=t(st.ms).reshape(7, 2, M, R),
        hw=t(st.hw).reshape(7, M, R), ex=t(st.ex).reshape(7, R),
        at=t(st.at).reshape(7, R), f2=t(st.f2).reshape(R),
        sh=t(st.sh).reshape(R))


def _port_fb2(fb2):
    return ps.FBv2(*(t(x) for x in fb2))


def test_gather_family_matches():
    ped, fb, _, _, _ = cohort(with_vacant=True)
    focals = list(ped.dous)
    from cnf2freq_tpu.hmm.family import gather_family as jg
    ref = jg(ped, focals, 0, ped.num_markers - 1, n_variants=1)
    got = gather_family(ped, focals, 0, ped.num_markers - 1, n_variants=1)
    for name in ("md", "ms", "hw", "exists", "attop", "flag2ignore",
                 "shiftignore", "descendants", "slot_ind", "emptyslot",
                 "dup_flip"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (jnp.float64, RTOL, ATOL), (jnp.float32, 1e-4, 1e-6)])
def test_emission_matches_emission_tiles(dtype, rtol, atol):
    # vacant grandparent slots (F1 focals) included
    (fb, dists, cfg, params), (_, st, e, _) = _case(dtype, with_vacant=True)
    M = fb.md.shape[2]
    got = ps.emission(_port_slots(st, M), M, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(e), rtol=rtol,
                               atol=atol)


def test_emission_from_port_slots():
    """prep_slots + emission on the port's own batch (R padded to 32)."""
    (fb, dists, cfg, params), (_, _, e, _) = _case(with_vacant=True)
    B, _, M, _ = fb.md.shape
    st = ps.prep_slots(torch_batch(fb), torch.float64)
    assert st.R == 32
    got = ps.emission(st, M, cfg)
    np.testing.assert_allclose(got.numpy()[:, :, :B], np.asarray(e)[:, :, :B],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("M", [8, 1])
def test_sweeps_match_pallas(M):
    _, fb, dists, cfg, params = cohort(B=5, M=max(M, 2), seed=7)
    if M == 1:
        import dataclasses
        fb = dataclasses.replace(fb, md=fb.md[:, :, :1], ms=fb.ms[:, :, :1],
                                 hw=fb.hw[:, :, :1])
        dists = dists[:0]
    _, _, e, fb2 = _jax_pipeline(fb, dists, cfg, params)
    got = ps.fb_sweeps(t(e), t(dists), cfg, params)
    for name in fb2._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(fb2, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_sweeps_f32():
    _, fb, dists, cfg, params = cohort(B=5, M=8, seed=7)
    _, _, e, fb2 = _jax_pipeline(fb, dists, cfg, params, jnp.float32)
    got = ps.fb_sweeps(t(e), t(dists, torch.float32), cfg, params)
    for name in fb2._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(fb2, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_stats_match_stats_from_v2():
    (fb, dists, cfg, params), (_, st, _, fb2) = _case(B=6, M=9, seed=3)
    B, _, M, _ = fb.md.shape
    total = v2.combined_loglik_v2(fb2, st.sh)
    ref = v2.stats_from_v2(st, fb2, total, M, B, cfg, jnp.float64,
                           interpret=True)
    sp = _port_slots(st, M)
    pfb2 = _port_fb2(fb2)
    tot = ps.combined_loglik_v2(pfb2, sp.sh)
    np.testing.assert_allclose(tot.numpy(), np.asarray(total), rtol=RTOL,
                               atol=ATOL)
    got = pst.stats(sp, pfb2.fw_pre, pfb2.bw, pfb2.fw_pre_f, pfb2.bw_f, tot,
                    B, cfg)
    for name, g, r in zip(("b12", "accum", "pair"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_stats_marker_slabs():
    """stats_reference over marker slabs equals the one-slab result."""
    _, fb, dists, cfg, params = cohort(B=4, M=7, seed=5)
    B, _, M, _ = fb.md.shape
    st = ps.prep_slots(torch_batch(fb), torch.float64)
    fb2 = ps.fb_sweeps(ps.emission(st, M, cfg), t(dists), cfg, params)
    tot = ps.combined_loglik_v2(fb2, st.sh)
    args = (st, fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f, tot, B, cfg)
    whole = pst.stats_reference(*args)
    slabs = pst.stats_reference(*args, max_pairs=2 * B)
    for a, b in zip(whole, slabs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13,
                                   atol=1e-15)


def test_turns_match_pallas():
    (fb, dists, cfg, params), (fbj, st, _, fb2) = _case(B=6, M=9, seed=3)
    B = fb.md.shape[0]
    desc = fbj.descendants.astype(jnp.float64)
    ref = np.asarray(v2.turn_weights_v2_pallas(fb2, st.sh, desc, cfg, B,
                                               interpret=True))
    got = ps.turn_weights(_port_fb2(fb2), t(st.sh).reshape(-1), t(desc),
                          cfg, B).numpy()
    finite = ref > -1e14
    np.testing.assert_allclose(got[finite], ref[finite], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(finite, got > -1e14)


def test_chromosome_scan_matches_engine():
    _, fb, dists, cfg, params = cohort(B=4, M=7, seed=5)
    ref = jax_chromosome_scan(jax_batch(fb), jnp.asarray(dists), cfg,
                              params, use_scan_v2=True)
    got = chromosome_scan(torch_batch(fb), t(dists), cfg, params)
    for name in ("total", "haplo_b12", "inf_accum", "pair", "fw_pre",
                 "bw", "fw_pre_f", "bw_f", "coherence"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got.haplo_mask.numpy(),
                                  np.asarray(ref.haplo_mask))
    tw, rtw = got.turn_weight.numpy(), np.asarray(ref.turn_weight)
    finite = rtw > -1e14
    np.testing.assert_allclose(tw[finite], rtw[finite], rtol=1e-7, atol=1e-9)
    np.testing.assert_array_equal(finite, tw > -1e14)

