"""Stage breakdown of the port's main path on one GPU.

    python3 -m cnf2freq_tpu_torch.profile_slice [--out FILE.json]
        [--adaptive-relhaplo {on,off}] [--resident {auto,off}]
        [--flipmode {native,negshift}] [--markers M] [--spacing-cm CM]
        [--markerblock N]
        [--model {f2,ng2,nohaplo,selfing,relskewstates}]

Runs a slice of ``chip_smoke.py``, simulate_f2(n_f2=1000, n_markers=192,
n_founder_pairs=20, seed=7) in float32 on cuda, with adaptive relhaplo on
(the default: the classic pipeline with coherence) or off (the v2
pipeline), on the Driver's default iteration (``--resident auto``: the
device-resident one for the native flip mode, ``slice_resident``) or the
host-gathered one (``off``, ``slice_coherence`` and ``slice``), with the
native flip solver or the negshift pass, and with ``--markerblock N`` the
marker-blocked scan (``chip_smoke.py``'s ``slice_blocked`` is
``--markers 2048 --spacing-cm 0.05 --markerblock 256``), whose passes
are timed as ``blocked.pass_a``, ``blocked.pass_b`` (the carry-only
sweeps), ``blocked.pass_c`` (each block's sweeps, statistics, merges and
turn weights) and ``blocked.followups`` (coherence and map
re-estimation per block), and with ``--model ng2`` or ``nohaplo`` the
two-generation families on the same cohort (``chip_smoke.py``'s
``slice_ng2`` and ``slice_nohaplo``; their engines' sweeps and
statistics timed as ``scan.*``), with ``--model selfing`` the selfed
cohort simulate_selfed(n_lines=1000, n_markers=192, generations=4,
marker_spacing_cm=1.0, seed=3) and with ``--model relskewstates`` the F2
cohort, both through the extended engine (``chip_smoke.py``'s
``slice_selfing`` and ``slice_relskewstates``; the engine's stages
timed as ``ext.*``); ``--markerblock`` with ``--model ng2``, ``selfing``
or ``relskewstates`` runs the families' marker-blocked scan, timed as
``blocked_fam.pass_a``, ``blocked_fam.pass_b`` (the carry-only sweeps
with each block's emissions) and ``blocked_fam.pass_c`` (each block's
sweeps, statistics, merges and turn weights; ``chip_smoke.py``'s
``slice_blocked_selfing`` is ``--model selfing --markers 1024
--spacing-cm 0.1 --markerblock 256``): preprocess(), the early
iteration, then two full iterations.  For each it prints the wall seconds
of the whole call and of each driver stage (on the classic pipeline also
the scan's own stages, ``scan.*``), timed on the host around calls
bracketed by ``torch.cuda.synchronize()``, and the
iteration's ``inverted`` flag: an inverted iteration applied a phase
flip, which freezes the capped-gradient updates (scalefactor 0), so its
two update stages are overhead only and run no bisection.  One more full
iteration then runs under ``torch.profiler`` tracing the device only
(host-op records would count each copy twice): the device time of its
top operations, their sum over the iteration's wall time (the device's
busy share), and the peak device memory of the run.  Preprocess, the
first call, also pays the CUDA context's lazy loading, the first scan
the kernels' build (unless build/kernels holds them) and the first full
iteration the flip solver's.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import time

import torch

STAGES = ("_feasibility", "_compute_variances", "_score_turns",
          "_solve_scored", "_refresh_relhaplo", "_process_infprobs",
          "_update_haploweights",
          # the resident iteration: the device family gather (with the
          # skeleton's first gather and upload), the mirrors' checks and
          # uploads, the whole-cohort update with its readback, and the
          # writeback into the Pedigree
          "_fill_family_dev", "_md_ms_dev", "_param_dev", "_updates_resident",
          "_writeback_resident")
# driver-module functions timed under their own names: the host gather
# and the scan of the other iteration, the update arithmetic of the
# resident one, the negshift pass, parity mode's flip stage
FUNCTIONS = ("gather_family", "scan_merged", "resident_updates",
             "negshift_flips", "parent_swap_candidates",
             "apply_parent_swaps", "reference_flips")
# stages inside the classic scan (engine.chromosome_scan imports them at
# each call): (module, function)
SCAN_STAGES = (("hmm.emission", "build_blocks"),
               ("hmm.emission", "assemble_e_all"),
               ("hmm.forward_backward", "forward_backward"),
               ("hmm.probes", "turn_weights_fast"),
               ("hmm.probes", "phase_coherence"),
               # the two-generation engines' own references
               ("engine_ng2", "forward_backward"),
               ("engine_ng2", "haplo_stats_ng2"),
               ("engine_ng2", "infprob_stats_ng2"),
               ("engine_ng2", "turn_weights_fast"),
               ("engine_nohaplo", "forward_backward"),
               ("engine_nohaplo", "nohaplo_pair"))
# stages of the extended engine (engine_ext looks them up at each call)
EXT_STAGES = ("ext_blocks", "extended_forward_backward", "ext_statistics",
              "turn_weights_ext", "relskew_coherence_ext",
              "coherence_slot_ext")
# the passes of the marker-blocked scan: (module, function, stage)
BLOCKED_STAGES = (("ops.scan", "blocked_pass_a", "blocked.pass_a"),
                  ("ops.scan", "blocked_pass_b", "blocked.pass_b"),
                  ("ops.scan", "blocked_block_pass", "blocked.pass_c"),
                  ("driver", "Driver._blocked_followups",
                   "blocked.followups"),
                  # the families' blocked scan (blocked_families.py)
                  ("blocked_families", "pass_a", "blocked_fam.pass_a"),
                  ("blocked_families", "pass_b", "blocked_fam.pass_b"),
                  ("blocked_families", "family_block_pass",
                   "blocked_fam.pass_c"))


@contextlib.contextmanager
def stage_timers():
    """Accumulate synchronised wall seconds per stage while active."""
    import importlib

    from . import driver as dm
    acc = collections.defaultdict(float)

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out
        return run

    saved = {f: getattr(dm, f) for f in FUNCTIONS}
    saved_methods = {m: getattr(dm.Driver, m) for m in STAGES}
    add_coh = dm.ResidentAccum.add_coh
    saved_scan = [(importlib.import_module(f"{__package__}.{mod}"), name,
                   "scan." + name) for mod, name in SCAN_STAGES]
    saved_scan += [(importlib.import_module(f"{__package__}.engine_ext"),
                    name, "ext." + name) for name in EXT_STAGES]
    for mod, name, stage in BLOCKED_STAGES:
        obj = importlib.import_module(f"{__package__}.{mod}")
        if "." in name:
            cls, name = name.split(".")
            obj = getattr(obj, cls)
        saved_scan.append((obj, name, stage))
    saved_scan = [(obj, name, stage, getattr(obj, name))
                  for obj, name, stage in saved_scan]
    try:
        for name, fn in saved.items():
            setattr(dm, name, timed(name, fn))
        for name, fn in saved_methods.items():
            setattr(dm.Driver, name, timed(name, fn))
        for obj, name, stage, fn in saved_scan:
            setattr(obj, name, timed(stage, fn))
        dm.ResidentAccum.add_coh = timed("scatter_coherence", add_coh)
        yield acc
    finally:
        for name, fn in saved.items():
            setattr(dm, name, fn)
        for name, fn in saved_methods.items():
            setattr(dm.Driver, name, fn)
        for obj, name, _, fn in saved_scan:
            setattr(obj, name, fn)
        dm.ResidentAccum.add_coh = add_coh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--adaptive-relhaplo", choices=("on", "off"),
                    default="on")
    ap.add_argument("--resident", choices=("auto", "off"), default="auto")
    ap.add_argument("--flipmode", choices=("native", "negshift"),
                    default="native")
    ap.add_argument("--markers", type=int, default=192)
    ap.add_argument("--spacing-cm", type=float, default=1.0)
    ap.add_argument("--markerblock", type=int, default=None,
                    help="run chromosomes longer than this marker-blocked")
    ap.add_argument("--model", choices=("f2", "ng2", "nohaplo", "selfing",
                                        "relskewstates"),
                    default="f2", help="model family (the CLI's --model)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")

    from .utils.simulate import simulate_f2, simulate_selfed
    from torch.profiler import ProfilerActivity, profile

    from .cli import model_config
    from .driver import Driver
    if args.model == "selfing":
        ped = simulate_selfed(n_lines=1000, n_markers=args.markers,
                              generations=4,
                              marker_spacing_cm=args.spacing_cm, seed=3)
    else:
        ped = simulate_f2(n_f2=1000, n_markers=args.markers,
                          marker_spacing_cm=args.spacing_cm,
                          n_founder_pairs=20, seed=7)
    ped.config = model_config(args.model)
    if ped.config.deep_walk:
        # the reference's no-haplotyping fixtrees sets no founder flags
        for ind in ped.inds[1:]:
            ind.founder = False
    adaptive = args.adaptive_relhaplo == "on"
    drv = Driver(ped, dtype=torch.float32, device="cuda",
                 adaptive_relhaplo=adaptive)
    drv.flip_mode = args.flipmode
    drv.marker_block = args.markerblock
    if args.resident == "off":
        drv.resident = False
    calls = [("preprocess", drv.preprocess),
             ("iterate_early", lambda: drv.iterate(early=True))]
    calls += [(f"iterate_{i + 1}", drv.iterate) for i in range(2)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    report = {"device": torch.cuda.get_device_name(0),
              "card": smi.stdout.strip().splitlines()[0]
              if smi.returncode == 0 else "not read",
              "adaptive_relhaplo": adaptive, "flip_mode": drv.flip_mode,
              "resident": drv._use_resident(), "markers": args.markers,
              "model": args.model,
              "marker_block": args.markerblock, "stages": {}}
    with stage_timers() as acc:
        for name, fn in calls:
            acc.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            rec = dict(seconds=time.perf_counter() - t0, **acc)
            if out is not None:
                rec["inverted"] = out["inverted"]
            report["stages"][name] = rec
            print(name, json.dumps(rec), flush=True)
    print("card", report["card"])

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # timed inside the block: entering and leaving it (tracer set-up,
        # event processing) take seconds
        t0 = time.perf_counter()
        out = drv.iterate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def self_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    device_us = sum(self_us(e) for e in events)
    top = sorted(events, key=self_us, reverse=True)[:12]
    report["profiled_iteration"] = dict(
        seconds=wall, inverted=out["inverted"], device_ms=device_us / 1e3,
        busy_share=device_us / 1e6 / wall,
        top=[dict(op=e.key[:80], device_ms=self_us(e) / 1e3, count=e.count)
             for e in top])
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("profiled_iteration", json.dumps(report["profiled_iteration"]))
    print("peak_memory_gb", report["peak_memory_gb"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
