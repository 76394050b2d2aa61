"""The port's command line on the JAX CLI's other input sets, against the
JAX CLI (float64, on the CPU).

One ``simulate_f2(n_f2=12, n_markers=16)`` cohort is written by
``utils.simulate.write_cohort_files`` as MERLIN, Gigi, ccoeff and ShapeIT
haps with PLINK fam/bed and a VCF template.  Each set runs through the JAX
CLI (the port's determinism rules patched in, test-side:
``torch_port_util.run_jax_cli``) and the port's (``--device cpu``), both
with ``--count 3 --output --dump --trace`` (the haps set also
``--outputvcffile``; the line-origin reporter is held to the JAX CLI's on
the PlantImpute set in tests/test_torch_cli.py, and left out here to
spare four JAX compiles):

* the genotype table prints the same numbers to 2e-5, the rewritten VCF
  is the same text, and each dump the same numbers to 2e-5 except where a
  unit departed as described below;
* the trace files hold the same three ``iteration`` records;
* ``--createhapfile`` writes the same text from both CLIs and runs no
  iteration.

A departure the packages cannot avoid (ROADMAP Queue 3): the emission's
phase factor collapses for a homozygous member whose two markersure
values are exactly equal, and each package's update order may decide the
equality its own way (``utils.dumpcompare`` sets out the cause and the
rules).  On the haps set one of the 38 units (F2_7) departs so in the
third iteration, with every posterior, markerdata and markersure still
equal.  Each departed dump block must meet those rules, and a set may
hold at most ``MAX_DEPARTED`` of them.  Both CLIs' Drivers record the
collapse flags as each iteration starts.
"""
import json
import os

import pytest
from torch_port_util import (CLI_ATOL, assert_same_numbers, numbers,
                             run_jax_cli)

from cnf2freq_tpu.driver import Driver as JaxDriver
from cnf2freq_tpu_torch.cli import main as port_main
from cnf2freq_tpu_torch.driver import Driver
from cnf2freq_tpu_torch.utils.dumpcompare import (compare_dumps, dump_blocks,
                                                  faults, recording_collapse)
from cnf2freq_tpu_torch.utils.simulate import (COHORT_FORMATS, argv_of,
                                               simulate_f2,
                                               write_cohort_files)

RUNNERS = {"jax": (run_jax_cli, []), "port": (port_main, ["--device", "cpu"])}
COUNT = 3
# departed dump blocks a set may hold: one was seen (haps, F2_7)
MAX_DEPARTED = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ped = simulate_f2(n_f2=12, n_markers=16)
    root = tmp_path_factory.mktemp("formats_cli")
    out = {}
    for fmt in COHORT_FORMATS:
        d = str(root / fmt)
        flags = write_cohort_files(ped, d, fmt, seed=1)
        seen = {"jax": [], "port": []}
        for tag, (run, extra) in RUNNERS.items():
            argv = argv_of(flags) + ["--count", str(COUNT)] + extra
            for ext in ("output", "dump", "trace"):
                argv += [f"--{ext}", os.path.join(d, f"{tag}.{ext}")]
            if fmt == "haps":
                argv += ["--outputvcffile", os.path.join(d, f"{tag}.vcf")]
            cls = JaxDriver if tag == "jax" else Driver
            with recording_collapse(cls, seen[tag]):
                assert run(argv) == 0
        out[fmt] = (d, flags, seen)
    return out


@pytest.mark.parametrize("fmt", COHORT_FORMATS)
def test_format_cli_parity(runs, fmt, record_property):
    d, _, seen = runs[fmt]
    assert_same_numbers(os.path.join(d, "port.output"),
                        os.path.join(d, "jax.output"))
    n_inds = len(dump_blocks(os.path.join(d, "port.dump"))) // COUNT
    _, departed = compare_dumps(
        os.path.join(d, "port.dump"), os.path.join(d, "jax.dump"),
        seen["port"], seen["jax"], COUNT, CLI_ATOL)
    record_property("departed_dump_blocks", [tuple(d) for d in departed])
    assert not faults(departed, MAX_DEPARTED)
    if fmt == "haps":
        with open(os.path.join(d, "port.vcf")) as fp, \
                open(os.path.join(d, "jax.vcf")) as fj:
            text = fp.read()
            assert text == fj.read()
        recs = [ln for ln in text.splitlines() if not ln.startswith("#")]
        assert len(recs) == 16 and all(
            len(r.split("\t")) == 9 + n_inds for r in recs)
    # every unit of the format's worklist has a posterior table
    assert numbers(os.path.join(d, "port.output")).size > 0


@pytest.mark.parametrize("fmt", COHORT_FORMATS)
def test_format_trace_records(runs, fmt):
    """--trace: the same iteration records in both packages' JSON lines,
    one a run; the port's spans cover the iteration's stages."""
    d = runs[fmt][0]
    recs = {}
    for tag in RUNNERS:
        with open(os.path.join(d, f"{tag}.trace")) as f:
            recs[tag] = [json.loads(line) for line in f]
    its = {tag: [{k: v for k, v in r.items() if k != "t"}
                 for r in rs if r.get("event") == "iteration"]
           for tag, rs in recs.items()}
    assert len(its["port"]) == COUNT
    assert [r["iter"] for r in its["port"]] == [1, 2, 3]
    for a, b in zip(its["port"], its["jax"]):
        assert a.keys() == b.keys()
        assert a["scalefactor"] == pytest.approx(b["scalefactor"], rel=1e-12)
        assert {k: a[k] for k in a if k != "scalefactor"} == \
            {k: b[k] for k in b if k != "scalefactor"}
    spans = {r["name"] for r in recs["port"] if r["type"] == "span"}
    assert {"preprocess", "preprocess/correction_inference", "gather",
            "scan", "scatter", "coherence", "flips", "flips/optimise",
            "flips/optimise/score", "updates", "updates/device",
            "updates/writeback"} <= spans


def test_createhapfile(runs, capsys):
    """--createhapfile writes the phase-corrected haps file after the
    readers and returns before any iteration, in both CLIs alike."""
    d, flags, _ = runs["haps"]
    capsys.readouterr()
    texts = {}
    for tag, (run, extra) in RUNNERS.items():
        path = os.path.join(d, f"{tag}.created.haps")
        assert run(argv_of(flags) + ["--createhapfile", path] + extra) == 0
        with open(path) as f:
            texts[tag] = f.read()
    assert "iter " not in capsys.readouterr().err
    assert texts["port"] == texts["jax"]
    with open(flags["hapfiles"][0]) as f:
        assert len(texts["port"].splitlines()) == len(f.read().splitlines())
