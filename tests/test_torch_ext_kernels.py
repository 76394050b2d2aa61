"""The extended spaces' kernel twins against the JAX package, on the CPU.

Kernel #13 (the ``cnf_stats_ext_*`` entry of csrc/stats.cu, launched by
``engine_ext.ext_statistics`` on the card) and kernel #14 (the
``cnf_coherence_ext_*`` entry of csrc/coherence.cu, launched by
``engine_ext.coherence_ext``) run only on the card
(tests/test_torch_kernels_cuda.py holds them to these twins there).
Float64, one torch thread, on the model tests' cohorts
(tests/torch_ext_util.py: 6 x 16 selfed lines with 16 probe-dedup
variants under SELFING, 8 x 16 F2 units under RELSKEWSTATES), at the
model tests' rtol 1e-9 / atol 1e-12:

* ``ops.stats.stats_ext_reference`` on the JAX package's sweeps and
  totals (b12 per extension value, summed under each value's update
  mask; accum; pair) against JAX ``ext_statistics``, both models;
* ``ops.coherence.coherence_ext_reference`` against JAX
  ``coherence_slot_ext`` on all seven slots, SELFING;
* the routed ``ext_statistics`` and ``coherence_ext`` on CPU tensors
  equal the plain stages bit for bit;
* both wrappers raise on CPU tensors, a wrong shape or a wrong dtype
  before any launch.

The JAX side runs eagerly, only the stages these checks read, once a
process for this file and the model tests (``torch_ext_util.model_stages``).
"""
import numpy as np
import pytest
import torch
import torch_ext_util as U

from cnf2freq_tpu_torch import engine_ext as PE
from cnf2freq_tpu_torch.ops import coherence as pcoh
from cnf2freq_tpu_torch.ops import stats as pst

MODELS = ["selfing", "relskewstates"]


@pytest.fixture(scope="module")
def selfing():
    return U.model_stages("selfing")


@pytest.fixture(scope="module")
def relskewstates():
    return U.model_stages("relskewstates")


def _jax_sweeps(ref):
    """The JAX package's sweeps and totals as torch tensors."""
    f = ref["fbres"]
    fbres = PE.ExtFBResult(*(torch.as_tensor(np.array(getattr(f, k)))
                             for k in f._fields))
    return fbres, torch.as_tensor(np.array(ref["total"]))


def _port_stage(x):
    """The port's blocks, sweeps and totals on the cohort (CPU)."""
    blocks, _, colls, ovs, fbres = U.port_sweeps(x)
    total = PE.combined_loglik_ext(fbres, x["fbt"].shiftignore)
    return blocks, colls, ovs, fbres, total


@pytest.mark.parametrize("model", MODELS)
def test_stats_ext_reference_matches_jax(request, model):
    x, ref = request.getfixturevalue(model)
    fbt, cfg = x["fbt"], x["pcfg"]
    fbres, total = _jax_sweeps(ref)
    b12_v, inf, pair = pst.stats_ext_reference(
        fbt, fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, total, cfg,
        x["nv"])
    V = 3 if model == "selfing" else 2
    assert b12_v.shape == fbt.md.shape[:1] + fbt.md.shape[2:3] + (V, 7, 2)
    colls = PE.ext_collapses(fbt, cfg)
    b12 = torch.zeros_like(b12_v[:, :, 0])
    mask = torch.zeros(b12.shape[:-1], dtype=torch.bool)
    for v, mask_v in enumerate(PE.ext_update_masks(fbt, cfg, colls)):
        mask = mask | mask_v
        b12 = b12 + torch.where(mask_v[..., None], b12_v[:, :, v], 0.0)
    jb12, jmask, jinf, jpair = ref["stats"]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    U.close(b12, jb12, err_msg="b12")
    U.close(inf, jinf, err_msg="inf")
    U.close(pair, jpair, err_msg="pair")
    # informative: the statistics are not all zero
    assert float(np.abs(np.asarray(jb12)).max()) > 1e-3


def test_coherence_ext_reference_matches_jax(selfing):
    x, ref = selfing
    fbt, cfg = x["fbt"], x["pcfg"]
    blocks, _, _, _, _ = _port_stage(x)
    fbres, _ = _jax_sweeps(ref)
    d = torch.as_tensor(x["dists"])
    lam = PE._lam(cfg, x["pparams"], d, torch.float64)
    C = PE._vcoupling(fbt, cfg, x["pparams"], d, torch.float64)
    got = pcoh.coherence_ext_reference(fbres, blocks, fbt, cfg, lam, C)
    assert got.shape == fbt.md.shape[:1] + fbt.md.shape[2:3] + (7,)
    U.close(got, ref["coh"])
    assert (np.abs(np.asarray(ref["coh"])[:, :-1] - 0.5) > 1e-3).any()


@pytest.mark.parametrize("model", MODELS)
def test_routed_stages_on_cpu_are_the_twins(request, model):
    """On CPU tensors ext_statistics is the posterior weights and
    ext_statistics_reference, and (SELFING) coherence_ext the stack of
    coherence_slot_ext over the slots, bit for bit; no kernel launches."""
    x, _ = request.getfixturevalue(model)
    fbt, cfg, params = x["fbt"], x["pcfg"], x["pparams"]
    blocks, colls, ovs, fbres, total = _port_stage(x)
    launches = (pst.stats_ext.launches, pcoh.coherence_ext.launches)
    got = PE.ext_statistics(fbres, total, fbt, cfg, x["nv"])
    W = PE.posterior_weight_ext(fbres, total, fbt.shiftignore)
    want = PE.ext_statistics_reference(W, blocks, colls, ovs, fbt, cfg,
                                       x["nv"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if model == "selfing":
        d = torch.as_tensor(x["dists"])
        coh = PE.coherence_ext(fbres, blocks, fbt, cfg, params, d)
        assert torch.equal(coh, torch.stack([PE.coherence_slot_ext(
            fbres, blocks, fbt, cfg, params, d, slot)
            for slot in range(cfg.numslots)], dim=-1))
        res = PE.chromosome_scan_ext(fbt, d, cfg, params,
                                     n_variants=x["nv"], with_coherence=True)
        assert torch.equal(res.coherence, coh)
        assert torch.equal(res.haplo_b12, want[0])
    assert (pst.stats_ext.launches, pcoh.coherence_ext.launches) == launches


@pytest.mark.parametrize("model", MODELS)
def test_wrappers_refuse_before_launch(request, model):
    """stats_ext and coherence_ext on CPU tensors, with a wrong shape or a
    wrong dtype, or (coherence_ext) under RELSKEWSTATES raise before any
    launch."""
    x, _ = request.getfixturevalue(model)
    fbt, cfg = x["fbt"], x["pcfg"]
    blocks, _, _, fbres, total = _port_stage(x)
    args = (fbt, fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, total,
            cfg, x["nv"])
    launches = (pst.stats_ext.launches, pcoh.coherence_ext.launches)
    for err, a in ((ValueError, args),
                   (ValueError, (args[0], args[1][:, :, :1], *args[2:])),
                   (TypeError, (args[0], args[1].float(), *args[2:])),
                   (ValueError, (*args[:7], 0))):
        with pytest.raises(err):
            pst.stats_ext(*a)
    d = torch.as_tensor(x["dists"])
    lam = PE._lam(cfg, x["pparams"], d, torch.float64)
    C = PE._vcoupling(fbt, cfg, x["pparams"], d, torch.float64)
    cargs = [fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, lam, C,
             [b.froot for b in blocks], [b.pb[0] for b in blocks],
             [b.pb[1] for b in blocks], fbt.flag2ignore, cfg]
    if model == "selfing":
        cases = ((ValueError, 0, cargs[0]), (ValueError, 4, lam[1:]),
                 (TypeError, 1, fbres.bw.float()))
        for err, i, v in cases:
            with pytest.raises(err):
                pcoh.coherence_ext(*cargs[:i], v, *cargs[i + 1:])
    else:
        with pytest.raises(NotImplementedError):
            pcoh.coherence_ext(*cargs)
    assert (pst.stats_ext.launches, pcoh.coherence_ext.launches) == launches
