"""Reference-parity harness.

The port's copy of ``cnf2freq_tpu/utils/refparity.py`` (numpy and
``subprocess``): the same names, signatures and behaviour, with
``state_from_pedigree`` reading the port's ``Pedigree``.

Runs the locally compiled reference binary (refbaseline/build_ref.py ->
.refbuild/cnf2freq_ref) on a PlantImpute dataset, parses its per-iteration
haplotype dump (writer: cnF2freq.cpp:8157-8194), and compares the state
trajectory against a Driver's, stage by stage.

The dump is the reference's live output contract at HEAD: per iteration,
for every individual with analysis state, a header line ``<id> <name>``
followed by one row per marker::

    haploweight  allele1  allele2   negshift  sure1 sure2 relhaplo [priors]

The port's ``io.outputs.write_haplotype_dump`` writes the same layout, so
the parser and the comparison also read the port's own dumps.

What can be checked where:

* ``parse_dump``, ``state_from_pedigree``, ``genotype_match`` and
  ``compare`` are pure numpy; they are held to the JAX package's functions
  on the port's own dumps (``tests/test_torch_refparity.py``).
* ``build_reference``, ``build_variant``, ``run_reference`` and
  ``run_reference_traced`` drive the reference binary under ``.refbuild/``
  (and ``.refbuild_<variant>/``) at the repository root, built from the
  reference sources by ``refbaseline/build_ref.py``.  A machine without
  those sources has no binary; ``have_reference()`` is then false and the
  tests that need it skip.

Determinism: the binary must run with OMP_NUM_THREADS=1 (verified
reproducible); the toulbar2 WCNF-solver stand-in must be on PATH.

Note on the PlantImpute demo's ``demooutput``: that 4-column
genotype-probability table was produced by a *pre-HEAD* reporter — at
HEAD the reporter calls are commented out (cnF2freq.cpp:5553, 5873), the
``pairvals`` feeding the 4-column layout are computed nowhere, and
``--output`` writes this haplotype dump instead.  The compiled HEAD
reference converges to a visibly different state than demooutput implies
(e.g. individual C marker 4: HEAD gives markerdata=(1,1), sure=(0.374,
0.367) vs demooutput's P(11)=0.652 row).  The parity target is therefore
the compiled reference binary itself, not the stale artifact.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
from typing import Dict, List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REFBUILD = os.path.join(REPO, ".refbuild")
REF_BINARY = os.path.join(REFBUILD, "cnf2freq_ref")
TOULBAR = os.path.join(REFBUILD, "toulbar2")


@dataclasses.dataclass
class IndState:
    """One individual's per-marker state in one dump block."""

    ind_id: int
    name: str
    haploweight: np.ndarray   # [M]
    markerdata: np.ndarray    # [M, 2] int
    negshift: np.ndarray      # [M]
    markersure: np.ndarray    # [M, 2]
    relhaplo: np.ndarray      # [M]


IterState = Dict[str, IndState]   # name -> state


def have_reference() -> bool:
    return os.path.exists(REF_BINARY) and os.path.exists(TOULBAR)


def variant_binary(variant: str) -> str:
    """Path of a settings-variant build (refbaseline/build_ref.py
    patch_settings): SELFING / RELSKEWSTATES compiled reference."""
    return os.path.join(REPO, ".refbuild_" + variant,
                        "cnf2freq_ref_" + variant)


def have_variant(variant: str) -> bool:
    return os.path.exists(variant_binary(variant)) and \
        os.path.exists(TOULBAR)


def build_variant(variant: str) -> None:
    import sys
    subprocess.run(
        [sys.executable, os.path.join(REPO, "refbaseline",
                                      "build_ref.py"), variant],
        check=True)


def _reference_env() -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["OMP_STACKSIZE"] = "128M"
    env["PATH"] = REFBUILD + os.pathsep + env.get("PATH", "")
    return env


def run_reference_traced(mapfile: str, pedfile: str, genfile: str,
                         count: int, workdir: str, n_markers: int,
                         binary: str = None, trace_env: dict = None):
    """Run the (variant) binary with REFTRACE instrumentation; returns
    (dump iters, parsed stderr traces).

    Traces parsed: ACC (i, marker) -> (haplobase, haplocount, negshift),
    INF (i, marker, side, allele) -> weight, PRB (n, marker, g, flag2,
    shift) -> posterior probe value.  All are per-doit-call streams in
    order; with count=2 exactly one doit runs (the reference main loop
    skips iteration 0), so the traces describe that single scan."""
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(workdir, "refdump.txt")
    env = _reference_env()
    env["REFTRACE"] = "1"
    env["REFTRACE5"] = "1"
    if trace_env:
        env.update(trace_env)
    cmd = [binary or REF_BINARY, "--mapfile", mapfile, "--pedfile",
           pedfile, "--genfile", genfile, "--output", out,
           "--count", str(count), "--tmppath", workdir]
    errpath = os.path.join(workdir, "ref_stderr.log")
    with open(os.path.join(workdir, "ref_stdout.log"), "w") as so, \
            open(errpath, "w") as se:
        subprocess.run(cmd, env=env, check=True, stdout=so, stderr=se)
    acc, inf, prb = {}, {}, {}
    with open(errpath) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "ACC":
                acc[(int(p[1]), int(p[2]))] = (
                    float(p[3]), float(p[4]), float(p[5]))
            elif p[0] == "INF":
                inf[(int(p[1]), int(p[2]), int(p[3]), int(p[4]))] = \
                    float(p[5])
            elif p[0] == "PRB":
                key = (int(p[1]), int(p[2]), int(p[3]), int(p[4]),
                       int(p[5]))
                prb[key] = prb.get(key, 0.0) + float(p[6])
    with open(out) as f:
        iters = parse_dump(f.read(), n_markers)
    return iters, dict(acc=acc, inf=inf, prb=prb)


def build_reference() -> None:
    """Compile the patched reference + solver shim into .refbuild/."""
    subprocess.run(
        ["python", os.path.join(REPO, "refbaseline", "build_ref.py")],
        check=True)
    subprocess.run(
        ["g++", "-O2", "-std=gnu++20", "-o", TOULBAR,
         os.path.join(REPO, "refbaseline", "toulbar2.cc")], check=True)


def run_reference(mapfile: str, pedfile: str, genfile: str, count: int,
                  workdir: str, n_markers: int,
                  extra_args: List[str] = ()) -> List[IterState]:
    """Run the reference binary for `count` iterations; return one parsed
    dump block per iteration.  Block 0 is the initial (post-postmarkerdata)
    state: the reference's main loop skips doit on iteration 0
    (cnF2freq.cpp:8131-8132), so block t reflects t full doit calls."""
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(workdir, "refdump.txt")
    cmd = [REF_BINARY, "--mapfile", mapfile, "--pedfile", pedfile,
           "--genfile", genfile, "--output", out,
           "--count", str(count), "--tmppath", workdir, *extra_args]
    with open(os.path.join(workdir, "ref_stdout.log"), "w") as so, \
            open(os.path.join(workdir, "ref_stderr.log"), "w") as se:
        subprocess.run(cmd, env=_reference_env(), check=True, stdout=so,
                       stderr=se)
    with open(out) as f:
        return parse_dump(f.read(), n_markers)


def parse_dump(text: str, n_markers: int) -> List[IterState]:
    """One ``IterState`` per dump block: a block ends where an individual
    id seen in it comes again.  Only the first seven columns are read (the
    priors, where present, are not)."""
    lines = text.splitlines()
    iters: List[IterState] = []
    cur: IterState = {}
    seen_ids = set()
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if len(parts) == 2 and parts[0].isdigit():
            ind_id = int(parts[0])
            name = parts[1]
            if ind_id in seen_ids:     # new iteration block starts
                iters.append(cur)
                cur = {}
                seen_ids = set()
            seen_ids.add(ind_id)
            hw = np.zeros(n_markers)
            md = np.zeros((n_markers, 2), dtype=np.int64)
            ns = np.zeros(n_markers)
            ms = np.zeros((n_markers, 2))
            rh = np.zeros(n_markers)
            for m in range(n_markers):
                f = lines[i + 1 + m].split()
                hw[m] = float(f[0])
                md[m] = (int(f[1]), int(f[2]))
                ns[m] = float(f[3])
                ms[m] = (float(f[4]), float(f[5]))
                rh[m] = float(f[6])
            cur[name] = IndState(ind_id, name, hw, md, ns, ms, rh)
            i += 1 + n_markers
        else:
            i += 1
    if cur:
        iters.append(cur)
    return iters


def state_from_pedigree(ped) -> IterState:
    """Snapshot the port's pedigree in the same shape for comparison.

    negshift is zeros, and relhaplo 0.5 where ``ind.relhaplo is None``,
    as in the JAX function; the dump writer writes 0.0 there
    (``io/outputs.write_haplotype_dump``), a disagreement kept from the
    JAX package."""
    out: IterState = {}
    for ind in ped.inds[1:]:
        if ind.haploweight is None:
            continue
        out[ind.name] = IndState(
            ind.n, ind.name,
            ind.haploweight.copy(),
            ind.markerdata.copy().astype(np.int64),
            np.zeros_like(ind.haploweight),
            ind.markersure.copy(),
            ind.relhaplo.copy() if ind.relhaplo is not None else
            np.full_like(ind.haploweight, 0.5))
    return out


def genotype_match(a: IndState, b: IndState) -> np.ndarray:
    """Per-marker: do the genotypes match as unordered pairs?"""
    direct = (a.markerdata == b.markerdata).all(axis=1)
    swapped = (a.markerdata == b.markerdata[:, ::-1]).all(axis=1)
    return direct | swapped


def compare(ref: IterState, got: IterState, atol_note: str = ""
            ) -> Dict[str, float]:
    """Max-abs deviations between two state snapshots.

    haploweight/markersure compare orientation-aware: if an individual's
    genotype rows are stored in swapped order, haploweight mirrors to
    1-hw and markersure swaps columns (cnF2freq.cpp:7790-7812 applies the
    same equivalence on deserialize).  Homozygous markers of ``ref`` are
    left out of the haploweight deviation, and names missing from ``got``
    are skipped."""
    worst = dict(haploweight=0.0, markersure=0.0, relhaplo=0.0,
                 genotype_mismatches=0.0)
    for name, r in ref.items():
        if name not in got:
            continue
        g = got[name]
        direct = (r.markerdata == g.markerdata).all(axis=1)
        swapped = (r.markerdata == g.markerdata[:, ::-1]).all(axis=1) \
            & ~direct
        ok = direct | swapped
        worst["genotype_mismatches"] += float((~ok).sum())
        hw = np.where(swapped, 1.0 - g.haploweight, g.haploweight)
        ms = np.where(swapped[:, None], g.markersure[:, ::-1], g.markersure)
        het = (r.markerdata[:, 0] != r.markerdata[:, 1])
        hwdev = np.abs(r.haploweight - hw)[ok & het]
        if hwdev.size:
            worst["haploweight"] = max(worst["haploweight"],
                                       float(hwdev.max()))
        msdev = np.abs(r.markersure - ms)[ok]
        if msdev.size:
            worst["markersure"] = max(worst["markersure"],
                                      float(msdev.max()))
        worst["relhaplo"] = max(worst["relhaplo"], float(
            np.abs(r.relhaplo - g.relhaplo).max()))
    return worst
