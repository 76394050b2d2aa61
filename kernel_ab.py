"""Time kernel bodies of two source trees, in turns, on one GPU.

    python3 kernel_ab.py --parent DIR [--group {blocked,ext}] [--out FILE.json]

run from the root of the repo.  DIR is another checkout's
``cnf2freq_tpu_torch`` package (say, the parent commit's, from
``git archive`` unpacked into a git-ignored directory).  The bodies are
that package ("parent") and this one ("change"), each imported under a
name of its own, so that its wrappers launch the kernels built from its
own ``csrc/`` (the parent builds only the sources timed here).  On the
same inputs, at the slices' shapes, the script times every entry of each
body in turns (parent, change, change, parent), each visit 3 rounds of 20
wrapper calls (CUDA events around the calls: the wrapper's Python
included) and 3 rounds of 20 bare launches (one CUDA graph of 20 wrapper
calls, replayed: the device work alone), and prints each body's median,
min and max over its visits, in ms a call.  The entries of the group
``blocked`` (the default):

  fb_carry_fwd / fb_carry_bwd   #2's carry-only entry, one block of the
                                blocked slice (K=256 markers at 0.05 cM,
                                1000 units, R=1024), random carries
  fb_sweep_init                 #2's full sweep from the same carries
  relskew_192 / relskew_2048    #9 on 3,040 rows of 192 and 2048 markers
  relskew_chain_192             #9 on 32 rows (one block): the chain
  capped_haplo / capped_infprob #8 on one real update of the slice
                                (chip_smoke.update_kernel_inputs)

and of the group ``ext``:

  stats_ext / stats_ext_relskewstates
                                #13 at the selfing and relskewstates
                                slices' stage inputs
                                (chip_smoke.ext_stage_inputs, 1000 x 192)
  coherence_ext                 #14 on the selfing inputs
  stats_bmns / coherence        #3b and #10 on the F2 slice's classic
                                sweeps (chip_smoke.kernel_inputs)

each in float32 and float64; an entry that a body lacks is timed for
the other body only.  Outputs are compared with the change's: max abs
difference printed.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys

import torch

import chip_smoke
from cnf2freq_tpu_torch.ops import scan as ps

# the sources the parent builds for each group (emission.cu holds
# cnf_error_string)
SOURCES = {"blocked": ("emission.cu", "fb_sweep.cu", "relskew.cu",
                       "capped.cu"),
           "ext": ("emission.cu", "stats.cu", "coherence.cu")}


def import_body(name, pkg_dir, group):
    """The package in ``pkg_dir`` imported as ``name``, its kernels built
    from the group's SOURCES only."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    b = importlib.import_module(name + "._build")
    srcs = [os.path.join(pkg_dir, "csrc", s) for s in SOURCES[group]]
    b.sources = lambda: srcs
    return mod


def carry_inputs(dtype):
    """One block of the blocked slice (K=256 at 0.05 cM, 1000 units) on
    the card: e, its eigenvalue rows, the row below, random carries."""
    fbt, dists, cfg, params = chip_smoke.kernel_inputs(dtype, 256, 0.05)
    st = ps.prep_slots(fbt, dtype)
    e = ps.emission(st, 256, cfg)
    lam = ps.sweep_eigenvalues(dists, cfg, params, dtype)
    gen = torch.Generator(device="cuda").manual_seed(9)

    def carry():
        return (torch.rand((512, st.R), generator=gen, device="cuda",
                           dtype=dtype),
                torch.randn((8, st.R), generator=gen, device="cuda",
                            dtype=dtype) * 3)
    return e, lam, lam[128].contiguous(), carry(), carry(), cfg


def ext_inputs(dtype):
    """The ext group's inputs on the card: #13's and #14's at the
    extended slices' stage inputs, #3b's and #10's on the F2 slice's
    classic sweeps."""
    from cnf2freq_tpu_torch.hmm.emission import assemble_e_all, build_blocks
    from cnf2freq_tpu_torch.hmm.forward_backward import (FBResult,
                                                         combined_loglik)
    from cnf2freq_tpu_torch.hmm.transition import (interval_recomb,
                                                   transition_eigenvalues)
    from cnf2freq_tpu_torch.ops import fb as pfb
    out = {m: chip_smoke.ext_stage_inputs(m, dtype)
           for m in ("selfing", "relskewstates")}
    fbt, dists, cfg, params = chip_smoke.kernel_inputs(dtype)
    blocks = build_blocks(fbt, cfg, dtype=dtype)
    lam = transition_eigenvalues(cfg, interval_recomb(cfg, params, dists))
    fbres = FBResult(*pfb.fb_sweeps(assemble_e_all(blocks, cfg), lam))
    out["f2"] = dict(fbt=fbt, cfg=cfg, blocks=blocks, lam=lam, fbres=fbres,
                     total=combined_loglik(fbres, fbt.shiftignore))
    return out


def ext_entries(pkg, inputs):
    """{name: zero-argument call of pkg's wrapper} of the ext group, the
    entries that pkg has"""
    st = importlib.import_module(pkg.__name__ + ".ops.stats")
    coh = importlib.import_module(pkg.__name__ + ".ops.coherence")
    out = {}
    for name, m in (("stats_ext", "selfing"),
                    ("stats_ext_relskewstates", "relskewstates")):
        x = inputs[m]
        f = x["fbres"]
        args = (x["fbt"], f.fw_pre, f.bw, f.fw_pre_f, f.bw_f, x["total"],
                x["cfg"], x["nv"])
        if hasattr(st, "stats_ext"):
            out[name] = (lambda a=args: st.stats_ext(*a))
    x = inputs["selfing"]
    f, bl = x["fbres"], x["blocks"]
    cargs = (f.fw_pre, f.bw, f.fw_pre_f, f.bw_f, x["lam"], x["C"],
             [b.froot for b in bl], [b.pb[0] for b in bl],
             [b.pb[1] for b in bl], x["fbt"].flag2ignore, x["cfg"])
    if hasattr(coh, "coherence_ext"):
        out["coherence_ext"] = lambda: coh.coherence_ext(*cargs)
    x = inputs["f2"]
    f, bl = x["fbres"], x["blocks"]
    sargs = (x["fbt"], f.fw_pre, f.bw, f.fw_pre_f, f.bw_f, x["total"],
             x["cfg"])
    out["stats_bmns"] = lambda: st.stats_pallas(*sargs)
    out["coherence"] = lambda: coh.coherence(
        f.fw_pre, f.bw, f.fw_pre_f, f.bw_f, x["lam"], bl.froot, bl.pb[0],
        bl.pb[1], x["fbt"].flag2ignore, x["cfg"])
    return out


def entries(pkg, inputs):
    """{name: zero-argument call of pkg's wrapper} of the blocked group"""
    scan = importlib.import_module(pkg.__name__ + ".ops.scan")
    e, lam, below, fwd, bwd, cfg = inputs["carry"]
    out = {"fb_carry_fwd": lambda: scan.fb_carry(e, lam, cfg, init=fwd),
           "fb_carry_bwd": lambda: scan.fb_carry(
               e, lam, cfg, init=bwd, backward=True, lam_below=below)}
    rs = importlib.import_module(pkg.__name__ + ".updates.relskew")
    for key, (hw, rh) in inputs["relskew"].items():
        out[key] = (lambda hw=hw, rh=rh: rs.relskew_ratio(hw, rh))
    out["fb_sweep_init"] = lambda: scan.fb_sweeps(
        e, None, cfg, None, lam_pad=lam, init_fwd=fwd, init_bwd=bwd)
    cap = importlib.import_module(pkg.__name__ + ".updates.capped")
    for name, args in inputs["capped"].items():
        out[name] = (lambda f=getattr(cap, name), a=args: f(*a))
    return out


def flat(x):
    if torch.is_tensor(x):
        return [x]
    return [t for y in x for t in flat(y)]


def time_bodies(calls, order, dtype, results):
    """Time each body's entries in turns (order, then reversed), print and
    append one record an (entry, body)."""
    ref = {k: [t.double() for t in flat(f())]
           for k, f in calls["change"].items()}
    torch.cuda.synchronize()
    times = {(b, k): ([], []) for b in calls for k in calls[b]}
    for b in order + order[::-1]:
        for k, f in calls[b].items():
            times[(b, k)][0].extend(chip_smoke.cuda_rounds(f, 3, 20))
            times[(b, k)][1].extend(chip_smoke.bare_rounds(f, 3, 20))
    for (b, k), (w, bare) in times.items():
        got = [t.double() for t in flat(calls[b][k]())]
        diff = max(float((g - r).nan_to_num(0.0).abs().max())
                   for g, r in zip(got, ref[k]))
        rec = dict(dtype=str(dtype).split(".")[-1], body=b, entry=k,
                   ms=statistics.median(w), ms_min=min(w), ms_max=max(w),
                   bare_ms=statistics.median(bare), bare_min=min(bare),
                   bare_max=max(bare), rounds=f"{len(w)}x20",
                   max_abs_diff_vs_change=diff)
        print(json.dumps(rec), flush=True)
        results.append(rec)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--group", choices=tuple(SOURCES), default="blocked")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA device")
    bodies = [("parent", import_body("parent_body",
                                     os.path.abspath(a.parent), a.group)),
              ("change", importlib.import_module("cnf2freq_tpu_torch"))]
    real = chip_smoke.update_kernel_inputs() if a.group == "blocked" \
        else None
    gen = torch.Generator().manual_seed(5)
    results = []
    for dtype in (torch.float32, torch.float64):
        if a.group == "ext":
            inputs = ext_inputs(dtype)
            calls = {name: ext_entries(pkg, inputs) for name, pkg in bodies}
            time_bodies(calls, [b for b, _ in bodies], dtype, results)
            del calls, inputs
            torch.cuda.empty_cache()
            continue
        def cast(args):
            return tuple(x.to(dtype) if torch.is_tensor(x)
                         and x.is_floating_point() else x for x in args)
        rel = {}
        for key, n, m in (("relskew_192", 3040, 192),
                          ("relskew_2048", 3040, 2048),
                          ("relskew_chain_192", 32, 192)):
            hw = torch.rand((n, m), generator=gen).to("cuda", dtype) * 0.9
            rh = torch.rand((n, m), generator=gen).to("cuda", dtype)
            rh = 0.5 + rh * 0.49
            rel[key] = (hw + 0.05, rh)
        inputs = {"carry": carry_inputs(dtype), "relskew": rel,
                  "capped": {k: cast(real[k]) for k in
                             ("capped_haplo", "capped_infprob")}}
        calls = {name: entries(pkg, inputs) for name, pkg in bodies}
        time_bodies(calls, [b for b, _ in bodies], dtype, results)
        del calls, inputs
        torch.cuda.empty_cache()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(card=torch.cuda.get_device_name(0),
                           results=results), f, indent=1)


if __name__ == "__main__":
    main()
