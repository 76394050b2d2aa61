"""Command-line interface of the port: ``python -m cnf2freq_tpu_torch``.

The flags of ``cnf2freq_tpu/cli.py`` (the reference's
boost::program_options surface, cnF2freq.cpp:7946-7988), with the same
names, defaults, help and semantics: every input set (PlantImpute,
ShapeIT haps with PLINK fam/bed, MERLIN, ccoeff, Gigi),
``--createhapfile``, the VCF rewrite, ``--trace`` and ``--model`` (f2,
ng2, nohaplo, and the extended state spaces selfing and relskewstates);
plus
``--device``: the port runs on the card unless it is asked for the CPU,
and never falls back from one to the other.
"""

from __future__ import annotations

import argparse
import contextlib
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
    p.add_argument("--samplefile", help="ShapeIT-style .sample file")
    p.add_argument("--bimfile", help="BIM file (with --samplefile)")
    p.add_argument("--hapfiles", nargs="+",
                   help="haps files: maximum realization then samples")
    p.add_argument("--famfile", help="PLINK fam file (with --bedfile)")
    p.add_argument("--bedfile", help="PLINK bed file (with --famfile)")
    p.add_argument("--createhapfile",
                   help="write a phase-corrected haps file and exit")
    p.add_argument("--merlinmap", help="MERLIN map file")
    p.add_argument("--merlinped", help="MERLIN ped file (with genotypes)")
    p.add_argument("--gigimapfile", help="Gigi-compatible map file")
    p.add_argument("--gigipedfile", help="Gigi-compatible ped file")
    p.add_argument("--templatevcffile", help="template VCF whose GT fields "
                   "get rewritten with the phased results")
    p.add_argument("--outputvcffile", help="output path for the rewritten "
                   "VCF (.gz for gzip)")
    p.add_argument("--markerinfo", help="ccoeff-style marker info file")
    p.add_argument("--ccoeffped", help="ccoeff-style pedigree file")
    p.add_argument("--ccoeffgen", help="ccoeff-style genotype file")
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
    p.add_argument("--model",
                   choices=("f2", "ng2", "nohaplo", "selfing",
                            "relskewstates"),
                   default="f2",
                   help="model family (the reference's settings.h "
                   "blocks, selected at runtime instead of recompile): "
                   "f2 = 64-state three-generation default; ng2 = "
                   "4-state two-generation (QTLMAS15 shape); nohaplo = "
                   "4-state F2 with no haplotyping (settings.h:60-73, "
                   "pure posterior computation); selfing = "
                   "HBD-extended selfed lines; relskewstates = "
                   "coherence-bit extension")
    p.add_argument("--flipmode", choices=("native", "negshift"),
                   default="native",
                   help="phase-flip optimizer: joint per-marker solver "
                   "(default) or the legacy single-member negshift path")
    p.add_argument("--parentswap", action="store_true",
                   help="with --flipmode negshift: also apply parent-"
                   "pair swap moves (parentswapnegshifts)")
    p.add_argument("--trace", help="write structured tracing/metrics as "
                   "JSON lines to this file; span summary on stderr")
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


# the model families, as the JAX CLI builds them
MODELS = {"f2": {},
          "ng2": dict(numgen=2),
          "nohaplo": dict(numgen=2, haplotyping=False, relskews=False,
                          do_infprobs=False),
          "selfing": dict(selfing=True),
          "relskewstates": dict(relskewstates=True)}


def model_config(name: str):
    from .config import ModelConfig
    return ModelConfig(**MODELS[name])


def load_input(args, cfg=None):
    """The pedigree of the input set the arguments name (the JAX CLI's
    order of precedence) under the model config ``cfg`` (default F2), or
    (None, rc) when the CLI returns without a run: 0 after
    --createhapfile, 2 without a complete input set."""
    from .pedigree import Pedigree
    if args.mapfile and args.pedfile and args.genfile:
        from .io import load_plantimpute
        return load_plantimpute(args.mapfile, args.pedfile, args.genfile,
                                config=cfg), 0
    if args.samplefile and args.bimfile and args.hapfiles:
        from .io.haps import create_hap_file, read_haps_full, read_sample
        ped = Pedigree(cfg)
        samples = read_sample(args.samplefile)
        read_haps_full(ped, samples, args.bimfile, list(args.hapfiles))
        if args.famfile and args.bedfile:
            from .io.plink import read_fam_bed
            read_fam_bed(ped, args.famfile, args.bedfile)
        if args.createhapfile:
            with open(args.createhapfile, "w") as f:
                create_hap_file(ped, samples, args.hapfiles[0], f)
            return None, 0
        return ped, 0
    if args.hapfiles and not args.samplefile:
        print("--hapfiles without --samplefile requires pre-loaded "
              "individuals; combine with another input set", file=sys.stderr)
        return None, 2
    if args.merlinmap and args.merlinped:
        from .io.merlin import read_merlin_map, read_merlin_ped
        ped = Pedigree(cfg)
        read_merlin_map(ped, args.merlinmap)
        read_merlin_ped(ped, args.merlinped)
        return ped, 0
    if args.markerinfo and args.ccoeffped and args.ccoeffgen:
        from .io.ccoeff import load_ccoeff
        return load_ccoeff(args.markerinfo, args.ccoeffped,
                           args.ccoeffgen, config=cfg), 0
    if args.gigimapfile and args.gigipedfile:
        from .io.gigi import load_gigi
        return load_gigi(args.gigimapfile, args.gigipedfile, cfg=cfg), 0
    print("need an input set: --mapfile/--pedfile/--genfile, "
          "--merlinmap/--merlinped, "
          "--gigimapfile/--gigipedfile, or "
          "--markerinfo/--ccoeffped/--ccoeffgen", file=sys.stderr)
    return None, 2


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

    ped, rc = load_input(args, model_config(args.model))
    if ped is None:
        return rc

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
    with contextlib.ExitStack() as stack:
        if args.trace:
            from .utils.tracing import Tracer
            driver.tracer = Tracer(sink=stack.enter_context(
                open(args.trace, "w")))
        _run(args, driver, ped)
        if args.trace:
            print(driver.tracer.report(), file=sys.stderr)
    return 0


def _run(args, driver, ped):
    """Preprocess, the iterations with their dumps and checkpoints, and
    the outputs."""
    from .io.outputs import (deserialize, output_ped, write_genotype_table,
                             write_haplotype_dump, write_line_origin_table)

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
    if args.templatevcffile and args.outputvcffile:
        from .io.vcf import output_vcf
        output_vcf(ped, args.templatevcffile, args.outputvcffile)


if __name__ == "__main__":
    raise SystemExit(main())
