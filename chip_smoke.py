"""Drive the PyTorch/CUDA port (cnf2freq_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order, each printing its lines (any failure exits non-zero):
  device   require CUDA; print nvidia-smi's name and power limit
  build    compile csrc/*.cu with nvcc (sm_90a), one nvcc per source, all
           started together, and link them into one library in
           build/kernels/
  kernels  each kernel against its plain PyTorch version on the card at
           the slices' shapes (M=192, B=1000), float32 and float64: max
           abs/rel error against the stated tolerance, and CUDA-event
           times taken in turns plain, kernel, kernel, plain: the kernel
           in 6 rounds of 20 launches (median, min and max), the plain
           version in 2 rounds of 3
  slice    simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20,
           seed=7) on cuda in float32 with adaptive_relhaplo=False (the
           v2 pipeline): preprocess(), iterate(early=True), iterate() x 2,
           with every launch counter of the path > 0 and finite outputs
  slice_coherence
           the same cohort with adaptive relhaplo (the default; the
           classic pipeline with coherence): preprocess(),
           iterate(early=True), iterate() x 2; fails on a launch counter
           of the path at 0, a non-finite output, a haploweight outside
           [0, 1], a relhaplo outside [1e-4, 1 - 1e-4], or no relhaplo
           moved from its loaded value
  parity   a 24 x 32 cohort, float64, two iterations on cuda and on the
           CPU, with adaptive relhaplo off and on: haploweights, relhaplo
           and pair tables agree to 1e-9, markerdata exactly
The launch counters are set to 0 just before each slice and read just
after it.  The last three lines are a JSON summary of the kernels, the
card's name and power limit, and {"ok": true, "device": {...}}.  Imports
nothing of JAX and nothing of the JAX package.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    # name: (source, replaced TPU kernel, path it lies on)
    "emission": ("cnf2freq_tpu_torch/csrc/emission.cu",
                 "cnf2freq_tpu/ops/scan_v2.py:154", "slice"),
    "fb_sweep": ("cnf2freq_tpu_torch/csrc/fb_sweep.cu",
                 "cnf2freq_tpu/ops/scan_v2.py:631", "slice"),
    "stats": ("cnf2freq_tpu_torch/csrc/stats.cu",
              "cnf2freq_tpu/ops/stats_pallas.py:509", "slice"),
    "turn": ("cnf2freq_tpu_torch/csrc/turn.cu",
             "cnf2freq_tpu/ops/scan_v2.py:808", "slice"),
    "fb_classic": ("cnf2freq_tpu_torch/csrc/fb_classic.cu",
                   "cnf2freq_tpu/ops/fb_pallas.py:55", "slice_coherence"),
    "stats_bmns": ("cnf2freq_tpu_torch/csrc/stats.cu",
                   "cnf2freq_tpu/ops/stats_pallas.py:612",
                   "slice_coherence"),
}
# operations per unit of work, counted from each kernel's arithmetic (for
# the bound; every kernel here is far below the card's compute balance):
# emission per (marker, unit): four threads' separable tables (~20 slot
# matches x ~12 + 16 entries x 6) + 512 outputs x 3; sweeps per (unit,
# shift, marker) and direction: 64 x 4 (clip, emit, sum, divide) + two
# 6-stage FWHTs (2 x 6 x 64) + 2 x 64 scalings; statistics per (marker,
# unit): ~19,800 (block math and contractions); turn per (marker, unit):
# three 512-point WHTs (3 x 9 x 512) + 4 x 512
OPS = {"emission": 2880, "fb_sweep": 2 * 1152, "stats": 19800,
       "turn": 15872, "fb_classic": 2 * 1152, "stats_bmns": 19800}
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores
# (rtol, atol) per dtype; f32 sweeps compound rounding over 192 markers
TOL = {torch.float64: (1e-9, 1e-12), torch.float32: (1e-3, 1e-5)}
# turn weights are log-ratios of xor-correlations: entries whose reference
# ratio is below exp(-cut) sit at the transform's rounding floor, so only
# the entries above it are compared value by value, with an absolute slack
# added to TOL.  In f32 the slack is the log of the 512-point transform's
# worst relative rounding at the cut, eps * 512 * e^5 = 9.1e-3; in f64 it
# is 1e-10, 1000x the 9.2e-14 measured at the slice's shapes (the worst
# case there, eps * 512 * e^20 = 5.5e-5, would pass an f32-precision
# kernel).
TURN = {torch.float64: dict(cut=20.0, slack=1e-10),
        torch.float32: dict(cut=5.0, slack=9.1e-3)}
RELHAPLO_CLIP = 1e-4


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def wrappers():
    from cnf2freq_tpu_torch.ops import fb as pfb
    from cnf2freq_tpu_torch.ops import scan as ps
    from cnf2freq_tpu_torch.ops import stats as pst
    return {"emission": ps.emission, "fb_sweep": ps.fb_sweeps,
            "stats": pst.stats, "turn": ps.turn_weights,
            "fb_classic": pfb.fb_sweeps, "stats_bmns": pst.stats_pallas}


def cuda_rounds(fn, rounds, reps):
    """Milliseconds per launch of fn() in each of ``rounds`` rounds of
    ``reps`` launches, by CUDA events, after one warm-up call."""
    fn()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return out


def in_turns(plain, kernel):
    """(kernel round times, plain_ms) measured plain, kernel, kernel,
    plain: the kernel in 2 x 3 rounds of 20 launches, the slow plain
    version in one round of 3 on either side."""
    p1 = cuda_rounds(plain, 1, 3)
    k = cuda_rounds(kernel, 3, 20) + cuda_rounds(kernel, 3, 20)
    p2 = cuda_rounds(plain, 1, 3)
    return k, (p1[0] + p2[0]) / 2


def nbytes(*xs):
    """Bytes of tensors (nested tuples allowed), each counted once."""
    total = 0
    for x in xs:
        if torch.is_tensor(x):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
    return total


def bound(name, moved, work):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = OPS[name] * work / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, ref, dtype):
    """(max abs err, max rel err, ok) under TOL[dtype]."""
    rtol, atol = TOL[dtype]
    g, r = got.double(), ref.double()
    if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
        return math.inf, math.inf, False
    diff = (g - r).abs()
    rel = diff / r.abs().clamp(min=atol)
    ok = bool((diff <= atol + rtol * r.abs()).all())
    return float(diff.max()), float(rel.max()), ok


def compare_all(gots, refs, dtype):
    """compare() over matching tensors, aggregated."""
    res = [compare(g, r, dtype) for g, r in zip(gots, refs)]
    return (max(x[0] for x in res), max(x[1] for x in res),
            all(x[2] for x in res))


def compare_turn(got, ref, dtype):
    """Log-ratio entries above -cut value by value (allowing the log of
    the transform's relative rounding at the cut); entries below it only
    have to stay below it on both sides."""
    cut, slack = TURN[dtype]["cut"], TURN[dtype]["slack"]
    hi = ref > -cut
    floor_ok = bool((got[~hi] <= -cut + 1.0).all()
                    and (got[hi] > -cut - 1.0).all())
    g, r = got[hi].double(), ref[hi].double()
    if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
        return math.inf, math.inf, False
    rtol, atol = TOL[dtype]
    diff = (g - r).abs()
    ok = floor_ok and bool((diff <= atol + slack + rtol * r.abs()).all())
    return (float(diff.max()), float((diff / r.abs().clamp(min=atol)).max()),
            ok)


def kernel_inputs(dtype):
    """The slice's cohort on the card as a family batch, with randomised
    haploweights and error rates so every block branch is exercised."""
    from cnf2freq_tpu_torch.config import ModelConfig, RuntimeParams
    from cnf2freq_tpu_torch.hmm.family import gather_family
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    ped = simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20, seed=7)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1,
                       n_variants=1)
    rng = np.random.default_rng(7)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    fbt = fb.to("cuda", dtype)
    dists = torch.as_tensor(np.diff(ped.markerposes), dtype=dtype,
                            device="cuda")
    return fbt, dists, ModelConfig(), RuntimeParams()


def check_kernels(dtype):
    """Each kernel vs its plain version; returns {name: record}."""
    from cnf2freq_tpu_torch.hmm.emission import assemble_e_all, build_blocks
    from cnf2freq_tpu_torch.hmm.forward_backward import (FBResult,
                                                         combined_loglik)
    from cnf2freq_tpu_torch.hmm.transition import (interval_recomb,
                                                   transition_eigenvalues)
    from cnf2freq_tpu_torch.ops import fb as pfb
    from cnf2freq_tpu_torch.ops import scan as ps
    from cnf2freq_tpu_torch.ops import stats as pst
    fbt, dists, cfg, params = kernel_inputs(dtype)
    st = ps.prep_slots(fbt, dtype)
    B, _, M, _ = fbt.md.shape
    out = {}

    def record(name, got, ref, kernel, plain, moved, work, cmp=compare,
               **tol):
        a, r, ok = cmp(got, ref, dtype)
        rounds, p_ms = in_turns(plain, kernel)
        k_ms = statistics.median(rounds)
        b_ms, b_by = bound(name, moved, work)
        out[name] = dict(max_abs_err=a, max_rel_err=r, ok=ok, ms=k_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        rtol, atol = TOL[dtype]
        say("kernels", dtype=str(dtype).split(".")[-1], kernel=name,
            max_abs_err=f"{a:.3e}", max_rel_err=f"{r:.3e}", rtol=rtol,
            atol=atol, **tol, ok=ok, ms=f"{k_ms:.4f}",
            ms_min=f"{min(rounds):.4f}", ms_max=f"{max(rounds):.4f}",
            rounds=f"{len(rounds)}x20", plain_ms=f"{p_ms:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by)

    # -- the v2 pipeline ([M, 512, R] layout) ---------------------------
    e = ps.emission(st, M, cfg)
    torch.cuda.synchronize()
    record("emission", e, ps.emission_reference(st, M, cfg),
           lambda: ps.emission(st, M, cfg),
           lambda: ps.emission_reference(st, M, cfg),
           nbytes(st.md, st.ms, st.hw, st.ex, st.at, e), M * st.R)

    lam_pad = ps.sweep_eigenvalues(dists, cfg, params, dtype)
    fb2 = ps.fb_sweeps(e, dists, cfg, params)
    ref2 = ps.fb_scan_v2(e, dists, cfg, params)
    torch.cuda.synchronize()
    record("fb_sweep", fb2, ref2,
           lambda: ps.fb_sweeps(e, dists, cfg, params),
           lambda: ps.fb_scan_v2(e, dists, cfg, params),
           nbytes(e, lam_pad, tuple(fb2)), st.R * 8 * M, cmp=compare_all)
    del ref2

    total = ps.combined_loglik_v2(fb2, st.sh)
    args = (st, fb2.fw_pre, fb2.bw, fb2.fw_pre_f, fb2.bw_f, total, B, cfg)
    got = pst.stats(*args)
    record("stats", got, pst.stats_reference(*args),
           lambda: pst.stats(*args), lambda: pst.stats_reference(*args),
           nbytes(tuple(st), args[1:6], got), M * B, cmp=compare_all)

    desc = fbt.descendants.to(dtype)
    got = ps.turn_weights(fb2, st.sh, desc, cfg, B)
    idx = torch.as_tensor(ps.turn_offsets(cfg), device="cuda")
    record("turn", got, ps.turn_weights_v2(fb2, st.sh, desc, cfg, B),
           lambda: ps.turn_weights(fb2, st.sh, desc, cfg, B),
           lambda: ps.turn_weights_v2(fb2, st.sh, desc, cfg, B),
           nbytes(fb2.fw_post, fb2.bw, fb2.fw_post_f, fb2.bw_f, st.sh, desc,
                  idx, got), M * B, cmp=compare_turn, **TURN[dtype])
    del e, fb2, got, args
    torch.cuda.empty_cache()

    # -- the classic pipeline ([B, M, NS, S] layout) --------------------
    e = assemble_e_all(build_blocks(fbt, cfg, dtype=dtype), cfg)
    lam = transition_eigenvalues(cfg, interval_recomb(cfg, params, dists))
    fbc = pfb.fb_sweeps(e, lam)
    ref = pfb.fb_sweeps_reference(e, lam)
    torch.cuda.synchronize()
    record("fb_classic", fbc, ref, lambda: pfb.fb_sweeps(e, lam),
           lambda: pfb.fb_sweeps_reference(e, lam),
           nbytes(e, lam, fbc), B * 8 * M, cmp=compare_all)
    del ref

    fbres = FBResult(*fbc)
    total = combined_loglik(fbres, fbt.shiftignore)
    args = (fbt, fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, total,
            cfg)
    got = pst.stats_pallas(*args)
    record("stats_bmns", got, pst.stats_bmns_reference(*args),
           lambda: pst.stats_pallas(*args),
           lambda: pst.stats_bmns_reference(*args),
           nbytes(fbt.md, fbt.ms, fbt.hw, fbt.exists.int(), fbt.attop.int(),
                  fbt.flag2ignore, fbt.shiftignore, args[1:6], got),
           M * B, cmp=compare_all)
    del e, fbc, fbres, got, args
    torch.cuda.empty_cache()
    return out


def run_slice(phase, adaptive):
    """The slice at 1000 x 192 in float32 through Driver.preprocess() and
    Driver.iterate(); returns the launch counts of the kernels of its
    path, read just after the run."""
    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    ped = simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20, seed=7)
    rh0 = np.stack([ind.relhaplo for ind in ped.inds[1:]]).copy()
    drv = Driver(ped, dtype=torch.float32, device="cuda",
                 adaptive_relhaplo=adaptive)
    wr = {k: fn for k, fn in wrappers().items() if KERNELS[k][2] == phase}
    for fn in wrappers().values():
        fn.launches = 0
    stages = [("preprocess", drv.preprocess),
              ("iterate_early", lambda: drv.iterate(early=True)),
              ("iterate_1", drv.iterate), ("iterate_2", drv.iterate)]
    for name, fn in stages:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        extra = {} if out is None else dict(
            loglik=f"{out['loglik']:.6f}", hitnnn=out["hitnnn"],
            scalefactor=f"{out['scalefactor']:.6g}",
            inverted=out["inverted"])
        say(phase, stage=name, seconds=f"{sec:.3f}", **extra)
        if out is not None and not math.isfinite(out["loglik"]):
            fail(f"{phase}: non-finite log-likelihood after {name}")
    launches = {k: fn.launches for k, fn in wr.items()}
    hw = np.stack([ind.haploweight for ind in ped.inds[1:]])
    rh = np.stack([ind.relhaplo for ind in ped.inds[1:]])
    tabs = np.stack(list(drv.pair_tables.values()))
    finite = bool(np.isfinite(hw).all() and np.isfinite(tabs).all()
                  and np.isfinite(rh).all())
    hw_ok = bool((hw >= 0).all() and (hw <= 1).all())
    moved = int((rh != rh0).sum())
    say(phase, launches=json.dumps(launches), finite=finite,
        haploweights_in_range=hw_ok, pair_tables=len(drv.pair_tables),
        relhaplo_moved=moved, relhaplo_min=f"{rh.min():.6g}",
        relhaplo_max=f"{rh.max():.6g}")
    if not (finite and hw_ok):
        fail(f"{phase}: non-finite or out-of-range outputs")
    if min(launches.values()) <= 0:
        fail(f"{phase}: a kernel of the path never launched: {launches}")
    if adaptive:
        if moved == 0:
            fail(f"{phase}: no relhaplo moved from its loaded value")
        if rh.min() < RELHAPLO_CLIP or rh.max() > 1 - RELHAPLO_CLIP:
            fail(f"{phase}: relhaplo outside [1e-4, 1 - 1e-4]")
    elif moved:
        fail(f"{phase}: relhaplo moved with adaptive relhaplo off")
    return launches


def run_parity(adaptive):
    """24 x 32 cohort, float64, two iterations on cuda and on the CPU."""
    from cnf2freq_tpu_torch import Driver, copy_pedigree
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    base = simulate_f2(n_f2=24, n_markers=32, n_founder_pairs=2, seed=11)
    peds = {dev: copy_pedigree(base) for dev in ("cuda", "cpu")}
    drivers = {dev: Driver(p, dtype=torch.float64, device=dev,
                           adaptive_relhaplo=adaptive)
               for dev, p in peds.items()}
    for d in drivers.values():
        d.preprocess()
        d.iterate(early=True)
        d.iterate()

    def stack(field):
        return {dev: np.stack([getattr(i, field) for i in p.inds[1:]])
                for dev, p in peds.items()}

    hw, rh, md = stack("haploweight"), stack("relhaplo"), stack("markerdata")
    tabs = {dev: d.pair_tables for dev, d in drivers.items()}
    hw_err = float(np.abs(hw["cuda"] - hw["cpu"]).max())
    rh_err = float(np.abs(rh["cuda"] - rh["cpu"]).max())
    pair_err = max(float(np.abs(tabs["cuda"][n] - tabs["cpu"][n]).max())
                   for n in tabs["cpu"])
    md_same = bool(np.array_equal(md["cuda"], md["cpu"]))
    moved = int((rh["cpu"] != 0.5).sum())
    ok = hw_err <= 1e-9 and rh_err <= 1e-9 and pair_err <= 1e-9 and md_same
    say("parity", adaptive_relhaplo=adaptive,
        haploweight_max_abs=f"{hw_err:.3e}", relhaplo_max_abs=f"{rh_err:.3e}",
        relhaplo_moved=moved, pair_max_abs=f"{pair_err:.3e}",
        markerdata_equal=md_same, tol=1e-9, ok=ok)
    if not ok:
        fail(f"cuda and CPU float64 runs disagree (adaptive={adaptive})")
    if adaptive and not moved:
        fail("parity: adaptive relhaplo left relhaplo at its loaded value")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say("device", card=card, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    from cnf2freq_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load_kernels(verbose=True)
    report = os.path.join(_build.build_dir(), "ptxas.txt")
    text = open(report).read() if os.path.exists(report) else ""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             text))
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        dir=_build.build_dir(), flags=" ".join(_build.NVCC_FLAGS),
        sources=len(_build.sources()), entry_functions=len(regs),
        max_registers=max(regs, default=None), spill_store_bytes=spills,
        ptxas_report=report)

    checks = {dt: check_kernels(dt) for dt in (torch.float64, torch.float32)}
    bad = [(str(dt), k) for dt, c in checks.items()
           for k, v in c.items() if not v["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    launches = run_slice("slice", adaptive=False)
    launches.update(run_slice("slice_coherence", adaptive=True))
    run_parity(adaptive=False)
    run_parity(adaptive=True)

    f32 = checks[torch.float32]
    summary = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k],
                    max_abs_err=f32[k]["max_abs_err"], ms=f32[k]["ms"],
                    plain_ms=f32[k]["plain_ms"], bound_ms=f32[k]["bound_ms"],
                    bound_by=f32[k]["bound_by"], library_ms=None)
               for k, (src, rep, _) in KERNELS.items()]
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
