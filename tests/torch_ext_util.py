"""Shared inputs and checks of the extended-state-space parity tests
(tests/test_torch_selfing.py, tests/test_torch_relskewstates.py).

Each model's cohort is built (``ext_inputs``) and the JAX package's
functions run on it (``jax_stages``, ``jax_reference``, eagerly: a jit of
the whole scan compiles for minutes on the CPU at 16 probe-dedup
variants) once a process (``model_stages``, ``model_reference``), which
the test files of that model and tests/test_torch_ext_kernels.py share;
the tests hold the port's functions against them in float64.  The Driver and
the CLI run on one PlantImpute file set (``files_pedigree``), so that the
JAX Driver's scan program compiles once for both.  JAX is imported inside
the functions that need it.
"""

import functools
import os

import numpy as np
import torch
from torch_port_util import (assert_same_numbers,
                             check_anchor_departures, check_iterations,
                             jax_batch, run_jax_cli, run_pair)

from cnf2freq_tpu_torch import Driver
from cnf2freq_tpu_torch import config as pconfig
from cnf2freq_tpu_torch import engine_ext as PE
from cnf2freq_tpu_torch.cli import main as port_main
from cnf2freq_tpu_torch.hmm.family import gather_family
from cnf2freq_tpu_torch.pedigree import from_host

# float64 on both sides; the sweeps differ only in the Walsh-Hadamard
# products' summation order (matrix products in JAX, butterflies here)
RTOL, ATOL = 1e-9, 1e-12


def close(got, ref, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).double().numpy(),
                               np.asarray(ref, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def ext_inputs(model):
    """The model tests' cohort: simulate_selfed(n_lines=6, n_markers=16,
    generations=4, seed=2) under SELFING, or simulate_f2(n_f2=8,
    n_markers=16, n_founder_pairs=2, seed=3) under RELSKEWSTATES with
    relhaplo drawn from U(0.2, 0.9), so that the coherence coupling is
    not flat; gathered with the Driver's probe-dedup variants, with
    haploweights and error rates randomised."""
    from cnf2freq_tpu.config import ModelConfig, RuntimeParams
    from cnf2freq_tpu.utils.simulate import simulate_f2, simulate_selfed
    if model == "selfing":
        ped = simulate_selfed(n_lines=6, n_markers=16, generations=4, seed=2)
        jcfg = ModelConfig(selfing=True)
    else:
        ped = simulate_f2(n_f2=8, n_markers=16, n_founder_pairs=2, seed=3)
        jcfg = ModelConfig(relskewstates=True)
        ped.config = jcfg
        rng = np.random.default_rng(5)
        for ind in ped.inds[1:]:
            if ind.relhaplo is not None:
                ind.relhaplo[:] = rng.uniform(0.2, 0.9, ind.relhaplo.shape)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    pp = from_host(ped)
    nv = Driver(pp, device="cpu")._n_variants()
    fb = gather_family(pp, list(ped.dous), 0, ped.num_markers - 1,
                       n_variants=nv)
    rng = np.random.default_rng(4)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    return dict(ped=ped, fb_np=fb, fbj=jax_batch(fb),
                fbt=fb.to("cpu", torch.float64),
                dists=np.diff(ped.markerposes), jcfg=jcfg,
                pcfg=pp.config, jparams=RuntimeParams(),
                pparams=pconfig.RuntimeParams(), nv=nv)


def jax_stages(x):
    """The JAX package's extended-engine stages on the cohort, each run
    once: blocks, sweeps, totals, posterior weights, statistics and the
    coherence (SELFING's seven slots, or RELSKEWSTATES' coherence bit)."""
    import jax.numpy as jnp

    from cnf2freq_tpu import engine_ext as JE
    fbj, cfg, params = x["fbj"], x["jcfg"], x["jparams"]
    d = jnp.asarray(x["dists"])
    blocks, e_ext, colls, ovs = JE.ext_blocks(fbj, cfg)
    fbres = JE.extended_forward_backward(e_ext, d, fbj, cfg, params)
    total = JE.combined_loglik_ext(fbres, fbj.shiftignore)
    W = JE.posterior_weight_ext(fbres, total, fbj.shiftignore)
    stats = JE.ext_statistics(W, blocks, colls, ovs, fbj, cfg, x["nv"])
    out = dict(blocks=blocks, e_ext=e_ext, collapses=colls, fbres=fbres,
               total=total, W=W, stats=stats)
    if cfg.selfing:
        out["coh"] = np.stack([np.asarray(JE.coherence_slot_ext(
            fbres, blocks, fbj, cfg, params, d, slot))
            for slot in range(cfg.numslots)], axis=-1)
    else:
        out["coh"] = JE.relskew_coherence_ext(fbres, e_ext, fbj, cfg, params,
                                              d)
    return out


def jax_reference(x, stages):
    """``stages`` (``jax_stages`` of the cohort) and the JAX package's
    other extended-engine functions on the cohort, each run once: turn
    weights, recombination expectations (from the sweeps and from the
    stored sweeps) and the model module's own scan."""
    import jax.numpy as jnp

    from cnf2freq_tpu import engine_ext as JE
    fbj, cfg, params = x["fbj"], x["jcfg"], x["jparams"]
    d = jnp.asarray(x["dists"])
    out = dict(stages)
    fbres, e_ext = out["fbres"], out["e_ext"]
    out["turn"] = JE.turn_weights_ext(fbres, fbj, cfg)
    if cfg.selfing:
        from cnf2freq_tpu.models import selfing as JM
        out["model_scan"] = JM.selfing_scan(fbj, d, fbj.selfgen, cfg, params)
    else:
        from cnf2freq_tpu.models import relskew_states as JM
        out["model_scan"] = JM.relstate_scan(fbj, d, fbj.relh[:, :-1], cfg,
                                             params)
    out["recomb"] = JE.recombination_expectations_ext(fbres, e_ext, fbj,
                                                      cfg, params, d)
    run = JE.make_jitted_recomb_ext(cfg, params)
    out["recomb_stored"] = getattr(run, "__wrapped__", run)(
        fbj, d, fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f)
    return out


@functools.lru_cache(maxsize=None)
def model_stages(model):
    """(ext_inputs(model), its jax_stages), computed once a process."""
    x = ext_inputs(model)
    return x, jax_stages(x)


@functools.lru_cache(maxsize=None)
def model_reference(model):
    """(ext_inputs(model), its jax_reference), computed once a process on
    model_stages."""
    x, stages = model_stages(model)
    return x, jax_reference(x, stages)


def port_sweeps(x):
    fbt, cfg, params = x["fbt"], x["pcfg"], x["pparams"]
    d = torch.as_tensor(x["dists"])
    blocks, e_ext, colls, ovs = PE.ext_blocks(fbt, cfg)
    fbres = PE.extended_forward_backward(e_ext, d, fbt, cfg, params)
    return blocks, e_ext, colls, ovs, fbres


# -- the checks ------------------------------------------------------------
def check_family(x):
    """The port's gather fills selfgen / relh as the JAX package's."""
    from cnf2freq_tpu.hmm.family import gather_family as jax_gather
    ped = x["ped"]
    fj = jax_gather(ped, list(ped.dous), 0, ped.num_markers - 1,
                    n_variants=x["nv"])
    fp = gather_family(from_host(ped), list(ped.dous), 0,
                       ped.num_markers - 1, n_variants=x["nv"])
    for f in ("md", "exists", "attop", "flag2ignore", "shiftignore",
              "slot_ind", "emptyslot", "dup_flip", "selfgen", "relh"):
        a, b = getattr(fp, f), getattr(fj, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)


def check_blocks_options(x, update, ci):
    """build_blocks with the family's root options (the selfing override,
    the RELSKEWSTATES no-collapse default) in the standard or the GENOS
    update mode, with or without ci."""
    from cnf2freq_tpu.hmm import emission as JEm

    from cnf2freq_tpu_torch.hmm import emission as PEm
    from cnf2freq_tpu_torch.models.selfing import hbd_overrides
    fbj, fbt = x["fbj"], x["fbt"]
    ovs_p, ovs_j = [None], [None]
    if x["pcfg"].selfing:
        from cnf2freq_tpu.models.selfing import collapse_focal
        import jax.numpy as jnp
        c, cs, _ = collapse_focal(fbj.md[:, 0], fbj.ms[:, 0])
        unk, zero = jnp.zeros_like(c), jnp.zeros_like(cs)
        one = jnp.ones_like(c, dtype=bool)
        ovs_j.append((unk, zero, c, cs, one))
        ovs_p.append(hbd_overrides(fbt.md[:, 0], fbt.ms[:, 0])[1])
    for ovp, ovj in zip(ovs_p, ovs_j):
        # (a dtype name: the JAX function's GENOS branch builds a numpy
        # array of it)
        bj = JEm.build_blocks(fbj, x["jcfg"], ci=ci, update=update,
                              root_override=ovj, dtype="float64")
        bp = PEm.build_blocks(fbt, x["pcfg"], ci=ci, update=update,
                              root_override=ovp)
        close(bp.froot, bj.froot)
        close(bp.top, bj.top)
        for k in range(2):
            close(bp.pb[k], bj.pb[k])
        close(PEm.assemble_e_all(bp, x["pcfg"]),
              JEm.assemble_e_all(bj, x["jcfg"]))


def check_probe_rule_factors(x, tied_rule):
    from cnf2freq_tpu.hmm.probes import probe_rule_factors as jax_prf

    from cnf2freq_tpu_torch.hmm.probes import probe_rule_factors
    import jax.numpy as jnp
    for v in range(x["nv"]):
        F0j, FPj = jax_prf(x["fbj"], x["jcfg"], np.dtype("float64"), v,
                           tied_rule=tied_rule)
        F0p, FPp = probe_rule_factors(x["fbt"], x["pcfg"], torch.float64, v,
                                      tied_rule=tied_rule)
        close(F0p, F0j)
        for k in range(2):
            close(FPp[k], FPj[k])


def check_ext_blocks(x, ref):
    blocks, e_ext, colls, _, _ = port_sweeps(x)
    close(e_ext, ref["e_ext"])
    for bp, bj in zip(blocks, ref["blocks"]):
        close(bp.froot, bj.froot)
        close(bp.top, bj.top)
        for k in range(2):
            close(bp.pb[k], bj.pb[k])
    for cp, cj in zip(colls, ref["collapses"]):
        np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))


def check_sweeps(x, ref):
    """The six sweep outputs (the plain twin of csrc/fb_ext.cu), the
    totals, the posterior weights and the turn weights."""
    *_, fbres = port_sweeps(x)
    for f in fbres._fields:
        close(getattr(fbres, f), getattr(ref["fbres"], f), err_msg=f)
    total = PE.combined_loglik_ext(fbres, x["fbt"].shiftignore)
    close(total, ref["total"])
    close(PE.posterior_weight_ext(fbres, total, x["fbt"].shiftignore),
          ref["W"])
    close(PE.turn_weights_ext(fbres, x["fbt"], x["pcfg"]), ref["turn"])


def check_statistics(x, ref):
    """ext_statistics_reference (the CPU route of ext_statistics) at the
    Driver's variant count, on the JAX package's posterior weights and
    the port's blocks."""
    blocks, _, colls, ovs, _ = port_sweeps(x)
    W = torch.as_tensor(np.array(ref["W"]))
    got = PE.ext_statistics_reference(W, blocks, colls, ovs, x["fbt"],
                                      x["pcfg"], x["nv"])
    for g, r, name in zip(got, ref["stats"], ("b12", "mask", "inf",
                                              "pair")):
        if name == "mask":
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            close(g, r, err_msg=name)


def check_coherence(x, ref):
    blocks, e_ext, _, _, fbres = port_sweeps(x)
    d = torch.as_tensor(x["dists"])
    if x["pcfg"].selfing:
        got = torch.stack([PE.coherence_slot_ext(
            fbres, blocks, x["fbt"], x["pcfg"], x["pparams"], d, slot)
            for slot in range(x["pcfg"].numslots)], dim=-1)
    else:
        got = PE.relskew_coherence_ext(fbres, e_ext, x["fbt"], x["pcfg"],
                                       x["pparams"], d)
    close(got, ref["coh"])
    # the statistic is informative: not every interval at 0.5
    assert (np.abs(np.asarray(ref["coh"])[:, :-1] - 0.5) > 1e-3).any()


def check_recombination(x, ref):
    from cnf2freq_tpu_torch.engine import ScanResult
    _, e_ext, _, _, fbres = port_sweeps(x)
    d = torch.as_tensor(x["dists"])
    close(PE.recombination_expectations_ext(fbres, e_ext, x["fbt"],
                                            x["pcfg"], x["pparams"], d),
          ref["recomb"])
    res = ScanResult(*([None] * 7), fw_pre=fbres.fw_pre, bw=fbres.bw,
                     fw_pre_f=fbres.fw_pre_f, bw_f=fbres.bw_f)
    close(PE.recomb_expectations_ext(x["fbt"], d, res, x["pcfg"],
                                     x["pparams"]), ref["recomb_stored"])


def check_chromosome_scan(x, ref, with_coherence):
    """chromosome_scan_ext whole against the JAX functions it composes."""
    res = PE.chromosome_scan_ext(x["fbt"], torch.as_tensor(x["dists"]),
                                 x["pcfg"], x["pparams"], n_variants=x["nv"],
                                 with_coherence=with_coherence)
    b12, mask, inf, pair = ref["stats"]
    want = dict(total=ref["total"], haplo_b12=b12, inf_accum=inf,
                pair=pair, turn_weight=ref["turn"],
                fw_pre=ref["fbres"].fw_pre, bw=ref["fbres"].bw,
                fw_pre_f=ref["fbres"].fw_pre_f, bw_f=ref["fbres"].bw_f)
    for f, r in want.items():
        close(getattr(res, f), r, err_msg=f)
    np.testing.assert_array_equal(res.haplo_mask.numpy(), np.asarray(mask))
    coh = np.full(res.coherence.shape, 0.5)
    if with_coherence:
        c = np.asarray(ref["coh"])
        if x["pcfg"].relskewstates:
            coh[..., 0] = c
        else:
            coh = c
    close(res.coherence, coh)


def check_driver(base, resident, record_property):
    """Driver.run's three iterations (the first early) against the JAX
    Driver on the same iteration branch."""
    kw = {} if resident else dict(resident=False)
    runs = run_pair(base, adaptive=True, jax_resident=resident, **kw)
    check_iterations(runs, ("haploweight", "markersure", "relhaplo"))
    check_anchor_departures(runs["seen"]["anchors"])
    j, p = runs["jax"], runs["torch"]
    assert not np.array_equal(p["post"]["haploweight"],
                              runs["raw"]["haploweight"])
    assert not np.array_equal(p["post"]["relhaplo"], runs["raw"]["relhaplo"])
    assert [m["hitnnn"] for m in p["metrics"]] == \
        [m["hitnnn"] for m in j["metrics"]]
    record_property("winner_departures", sum(runs["seen"]["winners"]))
    return runs


def check_cli(files, model, tmp_path):
    """Both CLIs with --model, --count 2 --output --dump, float64 on the
    CPU: every printed number within CLI_ATOL."""
    mapfile, pedfile, genfile = files
    d = str(tmp_path)
    for tag, run, extra in (("jax", run_jax_cli, []),
                            ("port", port_main, ["--device", "cpu"])):
        argv = ["--mapfile", mapfile, "--pedfile", pedfile, "--genfile",
                genfile, "--model", model, "--count", "2",
                "--output", os.path.join(d, f"{tag}.out"),
                "--dump", os.path.join(d, f"{tag}.dump")] + extra
        assert run(argv) == 0
    for ext in ("out", "dump"):
        assert_same_numbers(os.path.join(d, f"port.{ext}"),
                            os.path.join(d, f"jax.{ext}"))


def files_pedigree(files, model):
    """The JAX package's Pedigree of a file set under the model's config
    (the Driver tests' cohort: the CLI loads the same)."""
    from cnf2freq_tpu.config import ModelConfig
    from cnf2freq_tpu.io import load_plantimpute
    cfg = ModelConfig(selfing=True) if model == "selfing" else \
        ModelConfig(relskewstates=True)
    return load_plantimpute(*files, config=cfg)
