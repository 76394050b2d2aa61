"""The coherence-carrying scan of the port against the JAX package.

On one simulate_f2 cohort (5 units x 11 markers, float64, randomised
haploweights and error rates; it aligns with no batch tile) the port's
``turn_weights_fast``, ``phase_coherence`` (every slot, through
``phase_coherence_slot``), ``posterior_weight``, ``scatter_coherence`` and
``engine.chromosome_scan(with_coherence=True)`` are held against the JAX
functions at rtol 1e-10.  The port's sweeps clip at 1e-30 as the TPU
kernel does, the JAX package's CPU scan at 1e-300; the probabilities get
atol 1e-14 for that.  Turn weights are compared where finite (impossible
turns carry MINFACTOR on both sides).

The coherence kernel (csrc/coherence.cu) cannot run here, so its
arithmetic is emulated lane for lane (``_kernel_form``: the block's
path-sum tables, the emissions built from them, a row in four lanes of 16
states, the FWHT's stage order, lam / 64 between the transforms) and held
to the JAX ``phase_coherence`` at rtol 1e-10 on the same case, and to the
plain twin at its edges (a shift with no mass, a marker
with none, a zero backward row, an untyped unit) and on the marker-blocked
scan's boundary span.  On the CPU ``phase_coherence`` is the plain twin;
the wrapper's checks refuse a wrong type or shape before any launch.
These tests reuse ``_case`` and compile no JAX program of their own.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (boundary_span, coherence_edge_sweeps, cohort,
                             flat_unit, jax_batch, t, torch_batch)

from cnf2freq_tpu.engine import chromosome_scan as jax_chromosome_scan
from cnf2freq_tpu.hmm import probes as jax_probes
from cnf2freq_tpu.hmm.emission import assemble_e_all as jax_assemble_e_all
from cnf2freq_tpu.hmm.emission import build_blocks as jax_build_blocks
from cnf2freq_tpu.hmm.forward_backward import FBResult as JaxFBResult
from cnf2freq_tpu.hmm.transition import (interval_recomb as jax_recomb,
                                         transition_eigenvalues as jax_eig)
from cnf2freq_tpu.updates.scatter import (scatter_coherence as
                                          jax_scatter_coherence)
from cnf2freq_tpu_torch import _build
from cnf2freq_tpu_torch.config import ModelConfig
from cnf2freq_tpu_torch.engine import chromosome_scan
from cnf2freq_tpu_torch.hmm import probes
from cnf2freq_tpu_torch.hmm.emission import build_blocks
from cnf2freq_tpu_torch.ops import coherence as ocoh
from cnf2freq_tpu_torch.ops.scan import marker_slice
from cnf2freq_tpu_torch.updates.scatter import scatter_coherence

RTOL = 1e-10
PROB = dict(rtol=RTOL, atol=1e-14)
CASE = dict(B=5, M=11, seed=11)


@functools.lru_cache(maxsize=None)
def _programs():
    """(numpy cohort, JAX scan with coherence, the port's sweeps, the JAX
    turn weights, coherence and eigenvalues from those sweeps and the JAX
    blocks and emission of the cohort), each JAX program compiled once."""
    ped, fb, dists, cfg, params = cohort(**CASE)
    fbj = jax_batch(fb)
    dj = jnp.asarray(dists)
    res = jax.jit(lambda f, d: jax_chromosome_scan(
        f, d, cfg, params, with_coherence=True, use_scan_v2=False))(fbj, dj)

    @jax.jit
    def probes_of(f, d, fw_pre, fw_post, bw, fw_pre_f, fw_post_f, bw_f):
        fbres = JaxFBResult(fw_pre, fw_post, bw, fw_pre_f, fw_post_f, bw_f)
        blocks = jax_build_blocks(f, cfg, dtype=jnp.float64)
        lam = jax_eig(cfg, jax_recomb(cfg, params, d))
        return (jax_probes.turn_weights_fast(fbres, f, cfg),
                jax_probes.phase_coherence(fbres, blocks, f, cfg, lam), lam,
                blocks.froot, blocks.top, blocks.pb[0], blocks.pb[1],
                jax_assemble_e_all(blocks, cfg))

    sweeps = _sweeps(fb, dists, cfg, params)
    return (ped, fb, dists, cfg, params), res, sweeps, \
        probes_of(fbj, dj, *(jnp.asarray(x.numpy()) for x in sweeps))


def _case():
    """(numpy cohort, JAX scan with coherence, the port's sweeps, (JAX
    turn weights, coherence, eigenvalues))."""
    case, res, sweeps, out = _programs()
    return case, res, sweeps, out[:3]


def jax_blocks():
    """The JAX package's (froot, top, pb0, pb1, e) of ``_case``'s cohort:
    ``build_blocks`` + ``assemble_e_all`` in the same program."""
    return _programs()[3][3:]


def _sweeps(fb, dists, cfg, params):
    """The port's classic sweeps of the cohort (torch, float64)."""
    from cnf2freq_tpu_torch.hmm.emission import assemble_e_all
    from cnf2freq_tpu_torch.hmm.forward_backward import forward_backward
    fbt = torch_batch(fb)
    e = assemble_e_all(build_blocks(fbt, cfg), cfg)
    return forward_backward(e, t(dists), cfg, params)


def test_turn_weights_fast_matches():
    (_, fb, _, cfg, _), _, sweeps, (ref, _, _) = _case()
    got = probes.turn_weights_fast(sweeps, torch_batch(fb), cfg).numpy()
    ref = np.asarray(ref)
    finite = ref > -1e14
    np.testing.assert_array_equal(finite, got > -1e14)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=RTOL,
                               atol=1e-12)


def test_posterior_weight_matches():
    (_, fb, _, _, _), res, sweeps, _ = _case()
    total = t(np.asarray(res.total))
    got = probes.posterior_weight(sweeps, total, t(fb.shiftignore))
    ref = jax_probes.posterior_weight(
        JaxFBResult(*(jnp.asarray(x.numpy()) for x in sweeps)),
        jnp.asarray(res.total), jnp.asarray(fb.shiftignore))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_phase_coherence_matches():
    (_, fb, _, cfg, _), _, sweeps, (_, ref, lam) = _case()
    fbt = torch_batch(fb)
    blocks = build_blocks(fbt, cfg)
    got = probes.phase_coherence(sweeps, blocks, fbt, cfg, t(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    # coherence is a probability, measured away from the padding column
    assert ((got >= 0) & (got <= 1)).all()
    assert (got[:, :-1] != 0.5).any()
    # one slot on its own (its own pair total) equals its column
    one = probes.phase_coherence_slot(sweeps, blocks, fbt, cfg, t(lam), 4)
    np.testing.assert_allclose(one.numpy(), got[..., 4].numpy(), rtol=1e-13)


def test_scatter_coherence_matches():
    (ped, fb, _, _, _), res, _, _ = _case()
    coh = np.array(res.coherence)
    ids = [ind.n for ind in ped.inds[1:]]
    ind_index = {n: i for i, n in enumerate(ids)}
    NI, M = len(ids), ped.num_markers + 3
    lo = 2
    ref_num, ref_den = np.zeros((NI, M)), np.zeros((NI, M))
    jax_scatter_coherence(fb.slot_ind, fb.descendants, lo, coh, ref_num,
                          ref_den, ind_index)
    lut = np.full(max(ids) + 1, NI, dtype=np.int64)
    for n, i in ind_index.items():
        lut[n] = i
    num = torch.zeros((NI, M), dtype=torch.float64)
    den = torch.zeros((NI, M), dtype=torch.float64)
    scatter_coherence(t(fb.slot_ind), t(fb.descendants), lo, t(coh), num, den,
                      t(lut))
    np.testing.assert_allclose(num.numpy(), ref_num, rtol=RTOL)
    np.testing.assert_array_equal(den.numpy(), ref_den)
    assert ref_den[:, lo:lo + ped.num_markers].any()


def test_chromosome_scan_with_coherence_matches():
    (_, fb, dists, cfg, params), ref, _, _ = _case()
    got = chromosome_scan(torch_batch(fb), t(dists), cfg, params,
                          with_coherence=True)
    for name in ("total", "haplo_b12", "inf_accum", "pair", "fw_pre_f",
                 "bw_f", "coherence"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=1e-15, err_msg=name)
    for name in ("fw_pre", "bw"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **PROB)
    np.testing.assert_array_equal(got.haplo_mask.numpy(),
                                  np.asarray(ref.haplo_mask))
    tw, rtw = got.turn_weight.numpy(), np.asarray(ref.turn_weight)
    finite = rtw > -1e14
    np.testing.assert_array_equal(finite, tw > -1e14)
    np.testing.assert_allclose(tw[finite], rtw[finite], rtol=RTOL,
                               atol=1e-12)
    # without coherence the v2 pipeline runs, leaves coherence neutral and
    # gives the classic pipeline's statistics
    v2 = chromosome_scan(torch_batch(fb), t(dists), cfg, params)
    assert (v2.coherence == 0.5).all()
    for name in ("total", "haplo_b12", "inf_accum", "pair"):
        np.testing.assert_allclose(getattr(v2, name).numpy(),
                                   getattr(got, name).numpy(), rtol=RTOL,
                                   atol=1e-15, err_msg=name)
    tw2 = v2.turn_weight.numpy()
    np.testing.assert_array_equal(finite, tw2 > -1e14)
    np.testing.assert_allclose(tw2[finite], tw[finite], rtol=RTOL,
                               atol=1e-12)


def _fwht64_by4(x):
    """csrc/coherence.cu's fwht64_by4 on [P, 4, 16] rows (lane j of a
    row's four holds states 16 j + i): strides 1, 2, 4 and 8 inside the
    thread, then 16 and 32 across lanes (partner + sign * own)."""
    i = torch.arange(16)
    for h in (1, 2, 4, 8):
        lo = i[(i & h) == 0]
        a, b = x[..., lo], x[..., lo + h]
        x = x.clone()
        x[..., lo], x[..., lo + h] = a + b, a - b
    j = torch.arange(4)
    for o in (1, 2):
        sgn = torch.where((j & o) != 0, -1.0, 1.0).double()[:, None]
        x = x[:, j ^ o] + sgn * x
    return x


def _kernel_form(fbres, blocks, flag2ignore, lam):
    """csrc/coherence.cu's arithmetic lane for lane, every (unit, marker
    pair) a row of P: the eight path-sum tables of each marker (entry
    (r, fp, sk)), a shift's row in four lanes of 16 states (state 16 j + i
    = (b', a) with b' = 2 j + i // 8, a = i % 8), each emission value as
    (F L) R summed over r, the FWHT's stage order, lam / 64 between the
    transforms, a row's sum before its shift weight, the chains and the
    slot quotients."""
    B, M = fbres.fw_pre.shape[:2]
    lane = torch.arange(32)
    fp, sk = (lane >> 1) & 7, lane & 1
    p = torch.arange(8)
    x = p[None, :] ^ fp[:, None]                             # [lane, path]

    def sign(cond):
        return torch.where(cond, -1.0, 1.0).double()
    tabs = [None] * 8
    for k, slots in enumerate(((0, 2, 3, 4), (1, 5, 6, 7))):
        f2 = (flag2ignore.long() >> (1 + 3 * k)) & 7
        rows = blocks.pb[k].permute(0, 1, 2, 3, 5, 4).reshape(B, M, 32, 8)
        rows = torch.where(((p[None, :] & f2[:, None]) == 0)[:, None, None],
                           rows, 0.0)
        for i, sg in zip(slots, (None, sign(((x & 1) ^ sk[:, None]) != 0),
                                 sign((x & 2) != 0), sign((x & 4) != 0))):
            tabs[i] = (rows if sg is None else rows * sg).sum(-1)

    def pairs(z, q):
        return z[:, q:M - 1 + q].reshape((B * (M - 1),) + z.shape[2:])
    tab = [[pairs(tb, q) for tb in tabs] for q in range(2)]
    froot = [pairs(blocks.froot.reshape(B, M, 4), q) for q in range(2)]
    logw = pairs(fbres.fw_pre_f, 0) + pairs(fbres.bw_f, 1)
    w = torch.exp(logw - logw.max(dim=-1, keepdim=True).values)
    P = B * (M - 1)
    X = pairs(fbres.fw_pre, 0).reshape(P, 8, 4, 16)
    Y = pairs(fbres.bw, 1).reshape(P, 8, 4, 16)
    lam_p = (lam * (1.0 / 64.0))[None].expand(B, -1, -1).reshape(P, 4, 16)
    i = torch.arange(16)
    a = i & 7                                                 # [i]
    bp = 2 * torch.arange(4)[:, None] + (i >> 3)[None, :]     # [j, i]
    chains = []
    for v in range(8):
        lt = v if 2 <= v <= 4 else 0
        rt = v if v >= 5 else 1
        acc = 0.0
        for s in range(8):
            t_, u, vv = s & 1, (s >> 1) & 1, s >> 2

            def emission(q):
                """[P, 4, 16]: (F L) R summed over r, the twin's order"""
                e = 0.0
                for r in range(2):
                    f = froot[q][:, r * 2 + t_]
                    if v == 1 and r ^ t_:
                        f = -f
                    fl = f[:, None, None] * \
                        tab[q][lt][:, r * 16 + a * 2 + u][:, None, :]
                    e = e + fl * tab[q][rt][:, r * 16 + bp * 2 + vv]
                return e
            xs = _fwht64_by4(X[:, s] * emission(0))
            xs = _fwht64_by4(xs * lam_p)
            # a row's 64 states summed before its shift weight
            part = (xs * emission(1) * Y[:, s]).sum(dim=(-1, -2))
            acc = acc + w[:, s] * part
        chains.append(acc)
    tot = chains[0]
    ok = tot > 0
    cols = [torch.where(ok, 0.5 + 0.5 * c / torch.where(ok, tot, 1.0), 0.5)
            for c in chains[1:]]
    coh = torch.stack(cols, dim=-1).reshape(B, M - 1, 7)
    return torch.cat([coh, torch.full((B, 1, 7), 0.5, dtype=coh.dtype)],
                     dim=1)


def test_coherence_kernel_form_matches_jax():
    (_, fb, _, cfg, _), _, sweeps, (_, ref, lam) = _case()
    fbt = torch_batch(fb)
    got = _kernel_form(sweeps, build_blocks(fbt, cfg), fbt.flag2ignore,
                       t(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("case", ["edges", "flat_unit", "boundary_span"])
def test_coherence_kernel_form_edges(case):
    """The emulated kernel against the plain twin (held to the JAX
    function above) where totals vanish, on an untyped unit, and on the
    blocked scan's two-column stitch."""
    (_, fb, dists, cfg, params), _, sweeps, (_, _, lam) = _case()
    lam = t(lam)
    if case == "flat_unit":
        fb = flat_unit(fb, 3)
        sweeps = _sweeps(fb, dists, cfg, params)
    fbt = torch_batch(fb)
    if case == "edges":
        sweeps = coherence_edge_sweeps(sweeps)
    if case == "boundary_span":
        sweeps = boundary_span(sweeps, 4)
        fbt, lam = marker_slice(fbt, slice(4, 6)), lam[4:5]
    blocks = build_blocks(fbt, cfg)
    ref = probes.phase_coherence_reference(sweeps, blocks, fbt, cfg, lam)
    got = _kernel_form(sweeps, blocks, fbt.flag2ignore, lam)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=1e-15)
    if case == "edges":
        # the zero totals give the neutral 0.5 in every slot
        assert (ref[1, 5] == 0.5).all() and (ref[2, 6] == 0.5).all()
    if case == "flat_unit":
        assert (ref[3, :-1] != 0.5).any()


def test_phase_coherence_cpu_is_plain_twin():
    (_, fb, _, cfg, _), _, sweeps, (_, _, lam) = _case()
    fbt = torch_batch(fb)
    blocks = build_blocks(fbt, cfg)
    before = ocoh.coherence.launches
    got = probes.phase_coherence(sweeps, blocks, fbt, cfg, t(lam))
    ref = probes.phase_coherence_reference(sweeps, blocks, fbt, cfg, t(lam))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert ocoh.coherence.launches == before


def _meta_args(B=3, M=4, dtype=torch.float32, **shapes):
    """The wrapper's arguments as meta tensors (types and shapes, no
    data), with ``shapes`` overriding a named argument's shape."""
    want = dict(fw_pre=(B, M, 8, 64), bw=(B, M, 8, 64), fw_pre_f=(B, M, 8),
                bw_f=(B, M, 8), lam=(M - 1, 64), froot=(B, M, 2, 2),
                pb0=(B, M, 2, 8, 8, 2), pb1=(B, M, 2, 8, 8, 2))
    want.update(shapes)
    args = {k: torch.empty(v, dtype=dtype, device="meta")
            for k, v in want.items()}
    args["flag2ignore"] = torch.empty((B,), dtype=torch.int32, device="meta")
    return args


BAD_ARGS = {"fw_pre_shape": dict(fw_pre=(3, 4, 8, 32)),
            "lam_rows": dict(lam=(4, 64)),
            "pb1_shape": dict(pb1=(3, 4, 2, 8, 8))}


@pytest.mark.parametrize("bad", ["fw_pre_shape", "lam_rows", "pb1_shape",
                                 "bw_dtype", "froot_dtype", "not_cuda",
                                 "via_probes"])
def test_coherence_wrapper_checks(monkeypatch, bad):
    """Every refusal comes before a launch (and before the kernels are
    built); a tensor that is not on the card is refused, not routed to
    the plain twin."""
    from cnf2freq_tpu_torch.hmm.emission import EmissionBlocks
    from cnf2freq_tpu_torch.hmm.forward_backward import FBResult

    def no_launch(*a, **k):
        raise AssertionError("launched")
    monkeypatch.setattr(_build, "launch", no_launch)
    monkeypatch.setattr(_build, "load_kernels", no_launch)
    cfg = ModelConfig()
    args = _meta_args(**BAD_ARGS.get(bad, {}))
    if bad == "bw_dtype":
        args["bw"] = args["bw"].double()
    if bad == "froot_dtype":
        args["froot"] = args["froot"].half()
    before = ocoh.coherence.launches
    if bad == "via_probes":
        fbres = FBResult(args["fw_pre"], None, args["bw"], args["fw_pre_f"],
                         None, args["bw_f"])
        blocks = EmissionBlocks(froot=args["froot"], top=None,
                                pb=(args["pb0"], args["pb1"]),
                                focal_attop=None)
        fb = type("Batch", (), {"flag2ignore": args["flag2ignore"]})
        with pytest.raises(ValueError, match="CUDA"):
            probes.phase_coherence(fbres, blocks, fb, cfg, args["lam"])
    else:
        err, msg = ((TypeError, "dtype") if bad.endswith("dtype") else
                    (ValueError, "CUDA" if bad == "not_cuda" else "shape"))
        with pytest.raises(err, match=msg):
            ocoh.coherence(**args, cfg=cfg)
    assert ocoh.coherence.launches == before
