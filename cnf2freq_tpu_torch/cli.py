"""Command-line interface of the port: ``python -m cnf2freq_tpu_torch``.

The PlantImpute subset of ``cnf2freq_tpu/cli.py`` (the reference's
boost::program_options surface, cnF2freq.cpp:7946-7988), with the same
flag names, defaults and semantics, plus ``--device``: the port runs on
the card unless it is asked for the CPU, and never falls back from one to
the other.  Flags of the JAX CLI that the port does not carry yet (the
other readers, ``--model``, ``--trace``) are not defined, so argparse
refuses them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cnf2freq_tpu_torch",
        description="pedigree-HMM genotype/haplotype inference on the GPU "
        "(PyTorch/CUDA)")
    p.add_argument("--mapfile", help="PlantImpute cM map file")
    p.add_argument("--pedfile", help="PlantImpute pedigree file")
    p.add_argument("--genfile", help="PlantImpute genotype file")
    p.add_argument("--protmarkers", help="protected marker positions "
                   "(with --clear)")
    p.add_argument("--protinds", help="protected individuals (with --clear)")
    p.add_argument("--clear", action="store_true",
                   help="blank non-protected genotypes")
    p.add_argument("--impoutput", help="compare a previous genotype table "
                   "against current data and exit")
    p.add_argument("--count", type=int, default=3,
                   help="number of iterations")
    p.add_argument("--limit", type=int, default=None,
                   help="maximum number of individuals")
    p.add_argument("--output", help="output file for the genotype table")
    p.add_argument("--allblocks", action="store_true",
                   help="write a genotype-table block for every analysis "
                   "unit, including those with a data-less parental line "
                   "(default: the reference artifact's block set)")
    p.add_argument("--lineorigin", help="output file for posterior "
                   "line-origin class tables (founder-strain tracing)")
    p.add_argument("--deserialize", help="previous dump to restore")
    p.add_argument("--outputpedfile", help="write a ped file and exit-ish")
    p.add_argument("--capmarker", type=int, default=None,
                   help="limit marker count")
    p.add_argument("--dump", help="haplotype dump file (default stdout)")
    p.add_argument("--checkpoint", help="checkpoint file: the state dump "
                   "is written here (atomic rename) after every "
                   "iteration, and restored from it at startup when the "
                   "file exists — kill/resume-safe long runs")
    p.add_argument("--markerblock", type=int, default=None,
                   help="marker-blocked (checkpointed) scan for "
                   "chromosomes longer than this many markers: device "
                   "memory stays O(block) at any chromosome length")
    p.add_argument("--flipmode", choices=("native", "negshift"),
                   default="native",
                   help="phase-flip optimizer: joint per-marker solver "
                   "(default) or the legacy single-member negshift path")
    p.add_argument("--parentswap", action="store_true",
                   help="with --flipmode negshift: also apply parent-"
                   "pair swap moves (parentswapnegshifts)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs (default: the CUDA card; "
                   "without one the run fails rather than use the CPU)")
    p.add_argument("--x64", dest="x64", action="store_true",
                   default=None,
                   help="use float64 (default on the CPU)")
    p.add_argument("--f32", dest="x64", action="store_false",
                   help="use float32 (default on the card)")
    p.add_argument("--seed", type=int, default=0,
                   help="accepted as by the JAX CLI; the run draws no "
                   "random numbers")
    return p


def _write_checkpoint(path, driver, ped, iterations_done):
    from .io.outputs import write_haplotype_dump
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        st = driver.export_state()
        st["iterations_done"] = iterations_done
        f.write("# driverstate " + json.dumps(st) + "\n")
        write_haplotype_dump(ped, f, reset_negshift=False)
    os.replace(tmp, path)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.parentswap and args.flipmode != "negshift":
        # swap moves only exist on the legacy path; silently ignoring
        # the flag would surprise the user
        parser.error("--parentswap requires --flipmode negshift")
    if args.x64 is None:
        # default dtype by device: f32 on the card, f64 on the CPU, where
        # it matches the reference's precision
        args.x64 = args.device == "cpu"
        if not args.x64:
            print("# accelerator backend detected: defaulting to "
                  "float32 (pass --x64 to force float64)",
                  file=sys.stderr)

    from .driver import Driver
    from .io import load_plantimpute
    from .io.outputs import (deserialize, output_ped, write_genotype_table,
                             write_haplotype_dump, write_line_origin_table)

    if not (args.mapfile and args.pedfile and args.genfile):
        print("need an input set: --mapfile/--pedfile/--genfile",
              file=sys.stderr)
        return 2
    ped = load_plantimpute(args.mapfile, args.pedfile, args.genfile)

    if args.clear and not args.deserialize:
        from .io.masking import (clear_unprotected, read_protected_markers,
                                 read_protected_individuals)
        prot = read_protected_markers(args.protmarkers) \
            if args.protmarkers else set()
        pinds = read_protected_individuals(ped, args.protinds) \
            if args.protinds else set()
        clear_unprotected(ped, pinds, prot)

    if args.impoutput:
        from .io.masking import compare_imputed_output
        with open(args.impoutput) as f:
            nm = compare_imputed_output(ped, f, sys.stdout)
        print(f"{nm} mismatches", file=sys.stderr)
        return 0
    if args.capmarker:
        ped.markerposes = ped.markerposes[:args.capmarker]
        ped.chromstarts[-1] = min(args.capmarker, ped.chromstarts[-1])
    if args.limit is not None:
        ped.dous = ped.dous[:args.limit]

    # raises without a card when the card is asked for
    driver = Driver(ped, dtype=torch.float64 if args.x64 else torch.float32,
                    device=args.device)
    driver.flip_mode = args.flipmode
    driver.parent_swap = args.parentswap
    if args.markerblock:
        driver.marker_block = args.markerblock
    driver.preprocess()

    if args.deserialize:
        with open(args.deserialize) as f:
            sw = deserialize(ped, f)
        for n, s in sw.items():
            print(f"Switches {n} {ped.by_id(n).name}\t{s}")
    done = 0
    if args.checkpoint and not args.deserialize \
            and os.path.exists(args.checkpoint):
        with open(args.checkpoint) as f:
            head = f.readline()
            if head.startswith("# driverstate "):
                st = json.loads(head[len("# driverstate "):])
                driver.import_state(st)
                done = int(st.get("iterations_done", 0))
            else:
                f.seek(0)
            deserialize(ped, f)
        print(f"resumed from checkpoint {args.checkpoint} "
              f"({done} iterations done)", file=sys.stderr)

    if args.outputpedfile:
        output_ped(ped, args.outputpedfile)

    dump_out = open(args.dump, "w") if args.dump else sys.stdout
    for i in range(done, args.count):
        # the reference runs doit for every i, the first in "early" mode
        # (no phase-flip moves, cnF2freq.cpp:231, 8127-8132)
        info = driver.iterate(early=(i < 1))
        print(f"iter {i}: hitnnn={info['hitnnn']} "
              f"inverted={info['inverted']} "
              f"scalefactor={info['scalefactor']:.6f}", file=sys.stderr)
        write_haplotype_dump(ped, dump_out)
        if args.checkpoint:
            _write_checkpoint(args.checkpoint, driver, ped, i + 1)
    if args.dump:
        dump_out.close()

    if args.output:
        with open(args.output, "w") as f:
            write_genotype_table(ped, driver.pair_tables, f,
                                 include_all=args.allblocks)
    if args.lineorigin:
        with open(args.lineorigin, "w") as f:
            write_line_origin_table(ped, driver.line_origin_tables(), f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
