"""Stage breakdown of the port's main path on one GPU.

    python3 -m cnf2freq_tpu_torch.profile_slice [--out FILE.json]
        [--adaptive-relhaplo {on,off}]

Runs a slice of ``chip_smoke.py``, simulate_f2(n_f2=1000, n_markers=192,
n_founder_pairs=20, seed=7) in float32 on cuda, with adaptive relhaplo on
(the default: the classic pipeline with coherence, ``slice_coherence``) or
off (the v2 pipeline, ``slice``): preprocess(), the early iteration, then
two full iterations.  For each it prints the wall seconds of the whole
call and of each driver stage (on the classic pipeline also the scan's
own stages, ``scan.*``), timed on the host around calls bracketed by
``torch.cuda.synchronize()``, and the
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
import time

import torch

STAGES = ("_feasibility", "_compute_variances", "_score_turns",
          "_solve_scored", "_refresh_relhaplo", "_process_infprobs",
          "_update_haploweights")
# stages inside the classic scan (engine.chromosome_scan imports them at
# each call): (module, function)
SCAN_STAGES = (("hmm.emission", "build_blocks"),
               ("hmm.emission", "assemble_e_all"),
               ("hmm.forward_backward", "forward_backward"),
               ("hmm.probes", "turn_weights_fast"),
               ("hmm.probes", "phase_coherence"))


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

    saved = {"gather_family": dm.gather_family,
             "scan_merged": dm.scan_merged,
             "scatter_coherence": dm.scatter_coherence}
    saved_methods = {m: getattr(dm.Driver, m) for m in STAGES}
    scan = [(importlib.import_module(f"{__package__}.{mod}"), name)
            for mod, name in SCAN_STAGES]
    saved_scan = [(mod, name, getattr(mod, name)) for mod, name in scan]
    try:
        for name, fn in saved.items():
            setattr(dm, name, timed(name, fn))
        for name, fn in saved_methods.items():
            setattr(dm.Driver, name, timed(name, fn))
        for mod, name, fn in saved_scan:
            setattr(mod, name, timed("scan." + name, fn))
        yield acc
    finally:
        for name, fn in saved.items():
            setattr(dm, name, fn)
        for name, fn in saved_methods.items():
            setattr(dm.Driver, name, fn)
        for mod, name, fn in saved_scan:
            setattr(mod, name, fn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--adaptive-relhaplo", choices=("on", "off"),
                    default="on")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")

    from .utils.simulate import simulate_f2
    from torch.profiler import ProfilerActivity, profile

    from .driver import Driver
    ped = simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20, seed=7)
    adaptive = args.adaptive_relhaplo == "on"
    drv = Driver(ped, dtype=torch.float32, device="cuda",
                 adaptive_relhaplo=adaptive)
    calls = [("preprocess", drv.preprocess),
             ("iterate_early", lambda: drv.iterate(early=True))]
    calls += [(f"iterate_{i + 1}", drv.iterate) for i in range(2)]
    report = {"device": torch.cuda.get_device_name(0),
              "adaptive_relhaplo": adaptive, "stages": {}}
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
