"""Drive the PyTorch/CUDA port (cnf2freq_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order, each printing its lines, which end with the seconds
since the script started (t=); any failure exits non-zero:
  device   require CUDA; print nvidia-smi's name and power limit
  build    compile csrc/*.cu with nvcc (sm_90a), one nvcc per source, all
           started together, and link them into one library in
           build/kernels/
  kernels  each kernel against its plain PyTorch version on the card at
           the slices' shapes (M=192, B=1000), float32 and float64: max
           abs/rel error against the stated tolerance, and CUDA-event
           times taken in turns plain, kernel, kernel, plain: the kernel
           in 6 rounds of 20 launches (median, min and max), the plain
           version once on either side (the mean of the two); the sweep
           kernel's two entries of the
           marker-blocked scan at its block's shape (K=256 markers, 1000
           units, 0.05 cM apart): with seeded boundary carries
           (fb_sweep_init) and carry-only, forward and backward (fb_carry,
           timed per launch, and bare: a CUDA graph of the launches
           replayed, the device work without the wrapper's Python); in
           float32 there the kernel is held to its
           plain twin's accuracy against float64 (ACCURACY_SLACK); the
           statistics kernel's probe-rule entries (stats_rules,
           stats_bmns_rules: parity mode's form, one launch per dup-flip
           variant) on the same cohort gathered with 4 variants, every
           variant against the plain twin, timed on variant 1; the 4-state
           sweep entry of the two-generation families (fb_small: NS = 2,
           ng2; fb_small_nohaplo: NS = 1) at their 1000 x 192 inputs
           (F1 parents typed, weights randomised) at the XLA scan's clip;
           the extended sweeps (fb_ext: V = 3 at the selfing slice's
           inputs; fb_ext_relskewstates: V = 2 at the relskewstates
           slice's, relhaplo drawn from U(0.2, 0.95)) at 1000 x 192; the
           families' marker-blocked entries at one block (K=256) of the
           blocked family slices' cohorts, random boundary carries,
           float32 held to the plain twin's accuracy against float64:
           fb_small_init / fb_small_carry (ng2, NS = 2) and fb_ext_init /
           fb_ext_carry (selfing, V = 3), each carry row timed per launch;
           the update stage's kernels (capped_haplo, capped_infprob:
           csrc/capped.cu; relskew: csrc/relskew.cu) on the arguments of
           one real update of the slice's cohort (the default Driver's
           early iteration, at its starting scalefactor 0.013; float32 as
           captured, promoted to float64), the capped entries' values
           and hits bit for bit the plain version's, their bound reckoned
           from the lane-steps that the plain version took there
           (plain_lane_steps) and their divergence factors from the same
           steps (capped_divergence), then compared on synthetic lanes
           with the edges (edge_update_lanes) at that scalefactor and at 0,
           and each capped entry launched on two streams at once (the real
           lanes and the same rows reversed), each launch bit for bit the
           plain version's (capped_two_streams); relskew's ratios bit for
           bit, and its bare time, on the real update (192 markers: the
           body with its stored states in shared memory) and on its rows
           at slice_blocked's 2048 markers (their columns repeated: the
           body with its stored states in a device scratch,
           relskew_scratch_body);
           the classic scan's coherence kernel (coherence:
           csrc/coherence.cu, all seven slots in one launch) on the
           classic sweeps of the slice's cohort, float32 held to the
           plain twin's accuracy against float64
  slice    simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20,
           seed=7) on cuda in float32 with adaptive_relhaplo=False (the
           v2 pipeline) on the host-gathered iteration (resident=False):
           preprocess(), iterate(early=True), iterate() x 2, with every
           launch counter of the path > 0 and finite outputs; each update
           launches capped_haplo and capped_infprob once and relskew once
           a chromosome, and no synchronising call of a full iteration
           lies in updates/capped.py (every slice and the example check
           the same)
  slice_coherence
           the same cohort with adaptive relhaplo (the default; the
           classic pipeline with coherence), resident=False:
           preprocess(), iterate(early=True), iterate() x 2; fails on a
           launch counter of the path at 0, a non-finite output, a
           haploweight outside [0, 1], a relhaplo outside
           [1e-4, 1 - 1e-4], no relhaplo moved from its loaded value, or
           coherence launches other than stats_bmns's (one each a chunk
           scan)
  slice_resident
           the same cohort through the default Driver (the
           device-resident iteration, adaptive relhaplo) with a live
           Tracer: the same stages and checks, the peak device memory and
           the Tracer's span split of the preprocess and each iteration
           (host clock, unsynchronised); fails unless its full iterations
           make fewer synchronising calls than slice_coherence's, or if
           they make more than RESIDENT_SYNCS (4) in all
  mesh_world1
           the same cohort through the default Driver over a one-rank
           NCCL mesh (an in-process group on a FileStore, make_mesh(1)),
           in turns with the unmeshed Driver (MESH_WORLD1_TURNS: eight
           runs, four a side, in the order U M M U M U U M; preprocess(),
           iterate(early=True), iterate() x 4, each synchronised and
           timed): fails unless the meshed state
           (haploweights, genotypes, error rates, relhaplo, pair tables)
           and iteration records equal the unmeshed ones bit for bit,
           its fb_classic (#5) and stats_bmns (#3b) launches equal the
           unmeshed ones, and its median full iteration exceeds the
           unmeshed one by no more than the larger of 5% of it
           (MESH_WORLD1_SLOWDOWN) and the unmeshed samples'
           interquartile spread (a wider spread than 5% is printed as
           share_resolved=False); then one more full iteration with
           every all-reduce synchronised and timed (calls, seconds);
           peak memory of each run
  mesh_gloo2
           two ranks spawned (chip_smoke.py --mesh-rank ...) into a gloo
           group on cuda:0 (NCCL refuses two ranks on one card), each
           with Driver(mesh=make_mesh(2)): run_parity's 24 x 32 cohort in
           float64 (early + 2 full iterations) held to the card's
           unmeshed Driver at rtol 1e-9 / atol 1e-11 with equal hitnnn
           and inverted, each rank's checkpoint shard (save_sharded)
           loaded by a fresh unmeshed Driver that resumes one iteration;
           then the 1000 x 192 float32 slice per rank: stage seconds, one
           more full iteration with the all-reduces timed, launches, peak
           memory; the ranks must hold the same bits on both cohorts;
           a rank that fails or outlives MESH_RANK_TIMEOUT_S fails the
           phase
  mesh_nccl
           on a machine with two cards or more, mesh_gloo2's run over
           NCCL with min(cards, 4) ranks, one a card; on one card a line
           says it was skipped
  slice_negshift
           the same cohort with flip_mode="negshift" and
           parent_swap=True (the host-gathered iteration, the default
           for negshift): the same stages and checks.  Each slice also
           counts the calls that synchronise the host with the card in
           each iteration (torch.cuda.set_sync_debug_mode "warn") and
           prints the sites that made the most
  slice_blocked
           simulate_f2(n_f2=1000, n_markers=2048, marker_spacing_cm=0.05,
           n_founder_pairs=20, seed=7) (one chromosome of ~100 cM) in
           float32 through the default Driver with marker_block=256 (8
           blocks): preprocess(), iterate(early=True), iterate(); prints
           the seconds of passes A, B, C, the per-block follow-ups and
           the rest, the launches of emission, fb_sweep (pass C, with
           boundary carries), fb_carry (passes A and B), stats, turn and
           coherence (one a block and one a block boundary, each
           iteration), and the peak device memory of preprocess and of the
           iterations; fails on a launch count at 0 or a coherence count
           other than that, on more than one
           batch chunk, on a peak of 20 GB or more (either), on a
           non-finite output or if no relhaplo moved
  parity   a 24 x 32 cohort, float64, on cuda and on the CPU, two
           iterations on the host-gathered iteration (resident=False)
           and on the resident one, each with adaptive relhaplo off and
           on, then three with flip_mode="negshift" and
           parent_swap=True, then two marker-blocked (marker_block=8),
           then two with resident=True and marker_block=32 (no chromosome
           longer: the resident iteration): haploweights, relhaplo and
           pair tables agree to 1e-9, markerdata exactly
  blocked_parity
           simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20,
           seed=7) on cuda in float64, adaptive relhaplo off,
           resident=False, preprocess() and one full iteration, with
           marker_block=32 against the unblocked Driver: haploweights and
           pair tables at rtol 1e-8 / atol 1e-11, markerdata equal except
           at near-ties (markersure above 0.4)
  cli      the user's entry point from files, on the Driver's default
           (device-resident) iteration: simulate_plantimpute_files(
           n_f2=1000, n_markers=192, spacing_cm=1.0, missing_rate=0.3,
           error_rate=0.02, seed=11) written to a temporary directory, then
           cnf2freq_tpu_torch.cli.main (cuda, float32) with --count 3
           --output --dump --lineorigin --checkpoint, and a resume to
           --count 4 from the checkpoint; prints the seconds of each stage,
           the launches of fb_classic and stats_bmns (those of the
           line-origin pass apart), peak device memory and the imputation
           accuracy (argmax of the table's three classes against the
           simulated truth) on the masked (code 9) and on the observed
           entries; fails on a nonzero return, a kernel of the path at 0
           launches, a missing F2 block, a table row whose sum is more
           than 2e-5 from 1, a non-finite number, a resume that is not
           "(3 iterations done)" running iteration 3 alone, a dump that
           deserialize cannot read back, or masked-entry accuracy below
           0.95
  cli_parity
           simulate_plantimpute_files(n_f2=24, n_markers=32, seed=11)
           through the CLI in float64 with --device cuda and --device cpu
           (--count 2 --output --dump --lineorigin): every printed number
           of the genotype table, the line-origin table and the dump
           agrees to 2e-5
  cli_formats
           the slice's cohort written by utils.simulate.write_cohort_files
           as a ShapeIT set (.sample, .bim, two haps files, PLINK fam/bed,
           a VCF template; every sample an analysis unit: 3040 units)
           through cli.main on the card in float32 with --count 3 --dump
           --trace --outputvcffile, then one --createhapfile run; prints
           the seconds of reading, preprocess, each iteration and the
           writers, each iteration's inverted flag, the launches of
           fb_classic and stats_bmns, the chunks per iteration, the peak
           memory, the trace's ten longest spans and its split by
           iteration; fails on a nonzero return, a launch count off the
           chunk scans, other than 3 iteration records, a non-finite dump,
           a rewritten VCF without samples x markers valid GT fields, or a
           --createhapfile run that iterates or writes other than one line
           a marker
  cli_formats_parity
           a 24 x 32 cohort as MERLIN, Gigi, ccoeff and haps (+ fam/bed,
           VCF) through the CLI in float64, twice on cuda and once on the
           CPU (--count 3): the second card run writes the same bytes and
           iteration records as the first; card against CPU, every number
           of the genotype and line-origin tables within 2e-5, the same
           VCF and haps text, inverted flags, flips and scalefactors, the
           dumps within 2e-5 but for the collapse-tie departures that
           utils.dumpcompare admits (at most MAX_DEPARTED a set), and each
           iteration's hitnnn on the card equal to that of the update
           re-run on the CPU from the card's own inputs
           (run_cli_formats_parity)
  scan_parity
           engine.chromosome_scan(probe_rules=True, n_variants=4) on the
           slice's cohort (gathered as parity mode gathers it) in float32:
           the v2 pipeline (4 stats_rules launches) and the classic one
           with coherence (4 stats_bmns_rules); seconds, launches, peak
           memory; fails on a launch count off 4, a non-finite output, or
           statistics equal to the scan's without probe rules
  slice_parity
           Driver(parity=True) in float64 on simulate_f2(n_f2=PARITY_UNITS,
           n_markers=192, n_founder_pairs=20, seed=7): preprocess(), run(3)
           (two full iterations; iteration 0 is skipped); seconds of the
           scan, the reference flip stage and the updates, launches, peak
           memory and each iteration's flip winner; fails on a kernel of
           the path at 0 launches or a non-finite output
  parity_mode
           Driver(parity=True), 24 x 32, float64, run(3) on cuda and on the
           CPU: as simulated, then with the F1 parents marked typed (so
           that a flip wins), unblocked and with marker_block=8: the same
           flip winners, haploweights, markersure and pair tables at rtol
           1e-10 / atol 1e-12
  cli_models
           (run with the CLI phases) the cli phase's 1000 x 192 files
           through cli.main on the card in float32 with --model ng2, with
           --model nohaplo --lineorigin and with --model relskewstates,
           and 1000 x 192 selfed-line files with --model selfing and again
           with --markerblock 64, --count 2 --output --dump: stage
           seconds; fails on a nonzero return, a missing unit block, a
           non-finite number, a table row whose sum is more than 2e-5 from
           1, the family's sweep entries (fb_small, fb_ext, or the blocked
           fb_ext_init and fb_ext_carry) never launched or another kernel
           launched
  impute_example
           (run after cli_models) the port's imputation example,
           examples.impute_cohort.impute_cohort at 1000 x 192 with 4
           iterations, float32, on the card (simulate_f2(missing_rate=0.05,
           error_rate=0.01, seed=42), every 7th marker of each unit
           masked): the seconds of simulate + mask, preprocess, each
           iteration, line_origin_tables and each writer, the score and
           the exit code the JAX example's rule gives (printed, not
           asserted: held-out markersure settles above its strict 0.2
           threshold), the launches of fb_classic and stats_bmns, peak
           memory; fails if the example raises, a file is missing or
           empty, fb_classic launched fewer than iterations + 1 times or
           stats_bmns fewer than iterations times, or the dump, parsed by
           utils.refparity.parse_dump, departs from state_from_pedigree
           by a genotype or by more than the dump's rounding (DUMP_ATOL)
  impute_example_parity
           the example at 24 x 32 in float64 with 2 iterations on cuda
           and on the CPU: the genotype and line-origin tables within
           2e-5, the dumps within 2e-5 but for the collapse-tie
           departures that utils.dumpcompare admits (at most
           MAX_DEPARTED), the same score
  slice_ng2, slice_nohaplo
           family_ped's cohort (simulate_f2(n_f2=1000, n_markers=192,
           n_founder_pairs=20, seed=7) under ModelConfig(numgen=2), and
           under F2_NOHAPLO with founder flags cleared) in float32 through
           the default Driver (resident) and once more with resident=False:
           preprocess(), iterate(early=True), iterate() x 2; stage
           seconds, synchronising calls per full iteration, peak memory;
           fails on a non-finite output, a haploweight outside [0, 1], a
           nohaplo pair-table row further from summing to 1 than float32's
           rounding of the log-normalisers allows (family_row_tol), the
           4-state entry (csrc/fb_small.cu) never launched or any 64-state
           kernel launched
  parity (families)
           run_parity's 24 x 32 float64 cuda-vs-CPU check for ng2 (F1
           parents typed from the simulated truth) and nohaplo, 2
           iterations, resident and host-gathered, within its bounds
  slice_selfing, slice_relskewstates
           the extended state spaces' cohorts (simulate_selfed(
           n_lines=1000, n_markers=192, generations=4,
           marker_spacing_cm=1.0, seed=3) under ModelConfig(selfing=True),
           16 probe-dedup variants; simulate_f2(n_f2=1000, n_markers=192,
           n_founder_pairs=20, seed=7) under ModelConfig(
           relskewstates=True)) in float32 through the default Driver
           (resident, adaptive relhaplo) and once more with
           resident=False: preprocess(), iterate(early=True), iterate() x
           2, then (the resident run only) one more full iteration split
           by stage (synchronised; the engine's stages as ext.*); stage
           seconds, synchronising
           calls, chunk size, peak memory; fails on a non-finite output, a
           haploweight outside [0, 1], a relhaplo outside [1e-4, 1 - 1e-4]
           or none moved, fb_ext never launched or any other kernel
           launched
  parity (extended)
           run_parity's 24 x 32 float64 cuda-vs-CPU check for selfing
           (simulate_selfed(24, 32, seed=11)) and relskewstates, 2
           iterations, resident and host-gathered
  slice_blocked_selfing, slice_blocked_ng2
           the families' marker-blocked scan (blocked_families.py):
           simulate_selfed(n_lines=1000, n_markers=1024, generations=4,
           marker_spacing_cm=0.1, seed=3) under SELFING (16 variants), and
           simulate_f2(n_f2=1000, n_markers=1024, marker_spacing_cm=0.1,
           n_founder_pairs=20, seed=7) under ModelConfig(numgen=2) with
           the F1 parents typed, float32, marker_block=256 (4 blocks):
           preprocess(), iterate(early=True), iterate(), each stage's
           blocked_fam.* split (profile_slice.stage_timers, synchronised),
           the peak memory of preprocess and of the iterations; fails on
           more than one batch chunk, a blocked entry at 0 launches, any
           other kernel launched, a non-finite output, a haploweight
           outside [0, 1] or a peak of 40 GB or more
  parity, blocked_parity (blocked families)
           run_parity's 24 x 32 check with marker_block=8 for ng2,
           selfing and relskewstates (3 iterations; relhaplo keeps its
           values there), then each family at 200 x 192 in float64 on the
           card with marker_block=32 against its unblocked Driver, one
           full iteration, at the CPU tests' tolerances
The CLI and example phases share one temporary directory; each phase's
files are deleted once it has checked them, and a tmp_bytes_released
line gives their size.
The launch counters are set to 0 just before each slice, scan, CLI and
example run and read just after it; the kernels line takes the launches of the v2
kernels from slice, of the classic ones from slice_resident, of the
sweep kernel's two blocked entries from slice_blocked, of the update
stage's (capped_haplo, capped_infprob, relskew) from slice_resident, of
stats_rules
from slice_parity, of stats_bmns_rules from scan_parity, and of the
4-state entry (fb_small at NS = 2, fb_small_nohaplo at NS = 1) from the
resident slice_ng2 and slice_nohaplo, of the extended sweeps (fb_ext
at V = 3, fb_ext_relskewstates at V = 2) from the resident slice_selfing
and slice_relskewstates, and of the families' blocked entries from
slice_blocked_ng2 and slice_blocked_selfing.  The kernels phase holds the
4-state entry against its plain twin at both families' 1000 x 192 sweep
inputs.  The last
three lines are a JSON summary of the kernels, the card's name and power
limit, and {"ok": true, "device":
{...}}.  Imports nothing of JAX and nothing of the JAX package.
"""

import collections
import contextlib
import dataclasses
import datetime
import functools
import glob
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

KERNELS = {
    # name: (source, replaced TPU kernel, pipeline it lies on: v2 without
    # adaptive relhaplo, classic with it)
    "emission": ("cnf2freq_tpu_torch/csrc/emission.cu",
                 "cnf2freq_tpu/ops/scan_v2.py:154", "v2"),
    "fb_sweep": ("cnf2freq_tpu_torch/csrc/fb_sweep.cu",
                 "cnf2freq_tpu/ops/scan_v2.py:631", "v2"),
    "stats": ("cnf2freq_tpu_torch/csrc/stats.cu",
              "cnf2freq_tpu/ops/stats_pallas.py:509", "v2"),
    "turn": ("cnf2freq_tpu_torch/csrc/turn.cu",
             "cnf2freq_tpu/ops/scan_v2.py:808", "v2"),
    "fb_classic": ("cnf2freq_tpu_torch/csrc/fb_classic.cu",
                   "cnf2freq_tpu/ops/fb_pallas.py:55", "classic"),
    "stats_bmns": ("cnf2freq_tpu_torch/csrc/stats.cu",
                   "cnf2freq_tpu/ops/stats_pallas.py:612", "classic"),
    # the sweep kernel's entries of the marker-blocked scan: both sweeps
    # from boundary carries (pass C), and one carry-only direction
    # (passes A and B; the JAX package runs these as lax.scan loops,
    # scan_v2.py:285-323, beside the Pallas kernel)
    "fb_sweep_init": ("cnf2freq_tpu_torch/csrc/fb_sweep.cu",
                      "cnf2freq_tpu/ops/scan_v2.py:631", "blocked"),
    "fb_carry": ("cnf2freq_tpu_torch/csrc/fb_sweep.cu",
                 "cnf2freq_tpu/ops/scan_v2.py:285", "blocked"),
    # the statistics kernel's probe-rule form (_kernel with rules=True),
    # parity mode: launched per dup-flip variant by stats_from_v2 and by
    # stats_pallas
    "stats_rules": ("cnf2freq_tpu_torch/csrc/stats.cu",
                    "cnf2freq_tpu/ops/stats_pallas.py:509", "parity"),
    "stats_bmns_rules": ("cnf2freq_tpu_torch/csrc/stats.cu",
                         "cnf2freq_tpu/ops/stats_pallas.py:612", "parity"),
    # the 4-state sweeps of the two-generation families, a kernel for the
    # JAX package's XLA lax.scan (no Pallas kernel lies on these paths):
    # NS = 2 on the ng2 path, NS = 1 on the nohaplo path; one wrapper
    # counts both (ops.fb.fb_sweeps_small)
    "fb_small": ("cnf2freq_tpu_torch/csrc/fb_small.cu",
                 "cnf2freq_tpu/hmm/forward_backward.py:97", "ng2"),
    "fb_small_nohaplo": ("cnf2freq_tpu_torch/csrc/fb_small.cu",
                         "cnf2freq_tpu/hmm/forward_backward.py:97",
                         "nohaplo"),
    # the extended state spaces' sweeps, a kernel for the JAX package's
    # two XLA lax.scans of engine_ext.extended_forward_backward (forward
    # at :191, backward at :210): V = 3 on the selfing path, V = 2 on the
    # relskewstates path; one wrapper counts both (ops.fb.fb_ext)
    "fb_ext": ("cnf2freq_tpu_torch/csrc/fb_ext.cu",
               "cnf2freq_tpu/engine_ext.py:191", "selfing"),
    "fb_ext_relskewstates": ("cnf2freq_tpu_torch/csrc/fb_ext.cu",
                             "cnf2freq_tpu/engine_ext.py:191",
                             "relskewstates"),
    # the families' marker-blocked scan (blocked_families.py), kernels for
    # the JAX module's lax.scans: both sweeps from boundary carries (pass
    # C, block_pass at :210) and one carry-only direction (passes A and B,
    # carry_f at :143), on the 4-state rows (ng2) and the extended ones
    # (selfing, V = 3)
    "fb_small_init": ("cnf2freq_tpu_torch/csrc/fb_small.cu",
                      "cnf2freq_tpu/blocked_families.py:210", "blocked_ng2"),
    "fb_small_carry": ("cnf2freq_tpu_torch/csrc/fb_small.cu",
                       "cnf2freq_tpu/blocked_families.py:143",
                       "blocked_ng2"),
    "fb_ext_init": ("cnf2freq_tpu_torch/csrc/fb_ext.cu",
                    "cnf2freq_tpu/blocked_families.py:210",
                    "blocked_selfing"),
    "fb_ext_carry": ("cnf2freq_tpu_torch/csrc/fb_ext.cu",
                     "cnf2freq_tpu/blocked_families.py:143",
                     "blocked_selfing"),
    # the update stage, on every path that moves parameters: kernels for
    # the JAX package's jitted XLA loops (no Pallas kernel lies there), the
    # capped-gradient bisection's lax.while_loop (two lane-typed entries)
    # and the relskew HMM's lax.scans (forward at :50, backward at :66)
    "capped_haplo": ("cnf2freq_tpu_torch/csrc/capped.cu",
                     "cnf2freq_tpu/updates/capped.py:145", "update"),
    "capped_infprob": ("cnf2freq_tpu_torch/csrc/capped.cu",
                       "cnf2freq_tpu/updates/capped.py:145", "update"),
    "relskew": ("cnf2freq_tpu_torch/csrc/relskew.cu",
                "cnf2freq_tpu/updates/relskew.py:50", "update"),
    # the classic scan's adjacent-phase coherence, a kernel for the JAX
    # package's XLA program (hmm/probes.py:662-776, its phase_coherence
    # at :765): all seven slots' pair chains and their total in one launch
    "coherence": ("cnf2freq_tpu_torch/csrc/coherence.cu",
                  "cnf2freq_tpu/hmm/probes.py:765", "classic"),
}
UPDATE_KERNELS = tuple(k for k, v in KERNELS.items() if v[2] == "update")
# operations per unit of work, counted from each kernel's arithmetic (for
# the bound; every kernel here is far below the card's compute balance):
# emission per (marker, unit): four threads' separable tables (~20 slot
# matches x ~12 + 16 entries x 6) + 512 outputs x 3; sweeps per (unit,
# shift, marker) and direction: 64 x 4 (clip, emit, sum, divide) + two
# 6-stage FWHTs (2 x 6 x 64) + 2 x 64 scalings; statistics per (marker,
# unit): ~19,800 (block math and contractions), with probe rules 576 more
# (the 512 masked entries and 64 froot values decorated); turn per
# (marker, unit): three 512-point WHTs (3 x 9 x 512) + 4 x 512
OPS = {"emission": 2880, "fb_sweep": 2 * 1152, "stats": 19800,
       "turn": 15872, "fb_classic": 2 * 1152, "stats_bmns": 19800,
       "fb_sweep_init": 2 * 1152, "fb_carry": 1152,
       "stats_rules": 19800 + 576, "stats_bmns_rules": 19800 + 576,
       # per (unit, shift, marker) and direction: 4 x 4 (clip, emit, sum,
       # divide) + two 4-point FWHTs (2 x 2 x 4) + 2 x 4 scalings + a log
       "fb_small": 2 * 41, "fb_small_nohaplo": 2 * 41,
       # per (unit, shift, marker) and direction, V rows of 64: 4 (clip,
       # emit, sum, divide) + two 6-stage FWHTs (12) + 2 scalings + the
       # [V, V] mix (2V) per state, and a log
       "fb_ext": 2 * (3 * 64 * (18 + 2 * 3) + 1),
       "fb_ext_relskewstates": 2 * (2 * 64 * (18 + 2 * 2) + 1),
       # the blocked entries: both directions, or one (carry-only)
       "fb_small_init": 2 * 41, "fb_small_carry": 41,
       "fb_ext_init": 2 * (3 * 64 * (18 + 2 * 3) + 1),
       "fb_ext_carry": 3 * 64 * (18 + 2 * 3) + 1,
       # per (row, marker): forward (emission 3, mass 2, transition 7) and
       # backward (the same and the ratio's 4)
       "relskew": 28,
       # per (unit, marker pair): the path-sum tables (2 markers x 2
       # blocks x 32 entries x 8 paths x 4 sums) and, for each of 8
       # emissions x 8 shifts, both markers' emissions (2 x 64 x 3), two
       # 6-stage FWHTs (2 x 384), the product, scalings and dot product
       # (64 + 128 + 64 + 128)
       "coherence": 4096 + 64 * (384 + 768 + 64 + 128 + 64 + 128)}
# the capped entries' operations per lane-step and per lane, counting a
# log as one: a step is 16 gradient evaluations (the pseudo-likelihood
# term's 34 and two logs once its 13 products of (y, g, h) alone are
# formed a lane, then 11 for the entropy and relskew terms of a
# haploweight, 6 for the entropy and prior terms of a genotype) and ~124
# for the bisection and quadrature around them; a lane ~3 caps, those
# products and one evaluation more.  Their work is the lane-steps that the
# plain version took on the same inputs (plain_lane_steps).
CAPPED_OPS = {"capped_haplo": (16 * 47 + 124, 47 + 88),
              "capped_infprob": (16 * 42 + 124, 42 + 88)}
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores
FP64_OPS_PER_S = 34e12       # float64 outside the tensor cores
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
# float32 at the blocked slice's 0.05 cM spacing: transitions this close
# to the identity leave float32 itself ~1e-3 (relative) from float64 after
# a few dozen markers, the plain version as much as the kernel (my chip
# run, PR 9: max abs 1.36e-3 plain, 1.59e-3 kernel, against float64 on
# the same inputs).  There the float32 kernel is held to its plain twin's
# accuracy: its worst error against the float64 plain version, in units
# of TOL, within ACCURACY_SLACK times the float32 plain version's (or of
# TOL itself, where that is within TOL).
ACCURACY_SLACK = 2.0
RELHAPLO_CLIP = 1e-4
# the CLI's text outputs print 5-6 decimals
CLI_ATOL = 2e-5
# departed dump blocks an input set may hold in cli_formats_parity (see
# utils.dumpcompare): on an NVIDIA H100 the haps set holds four of its 228
# (F2_7, F2_11, F2_18 and F2_22, in the third iteration), the same four
# with the scatter sums unordered and ordered; the other sets none
MAX_DEPARTED = 4
MIN_MASKED_ACCURACY = 0.95
# the marker-blocked slice: its block, and the most device memory its
# iterations may hold (the unblocked working set at this size is ~67 GB)
BLOCK = 256
BLOCKED_PEAK_LIMIT = 20e9
# the families' blocked slices: markers, spacing (cM), and the most device
# memory a run may hold (unblocked, the selfed cohort's one chunk would
# need ~108 GB; one block's tensors ~27 GB)
FAMILY_BLOCKED_MARKERS = 1024
FAMILY_BLOCKED_SPACING = 0.1
FAMILY_BLOCKED_PEAK_LIMIT = 40e9
# parity mode: its probe-dedup variants on simulate_f2 cohorts, and the
# units of slice_parity, cut for the host flip stage (updates/refflips.py,
# Python whose cost grows faster than the units: the call of the second
# full iteration, the first with gainful turns, took 3.9 s at 40 units
# and over ten minutes at 100 on one CPU core)
PARITY_VARIANTS = 4
PARITY_UNITS = 40
PARITY_RTOL, PARITY_ATOL = 1e-10, 1e-12
# synchronising calls of slice_resident's two full iterations, which the
# Tracer's spans (host clock only) must not raise
RESIDENT_SYNCS = 4
# float32's unit roundoff, for the nohaplo slice's row-sum bound
# (family_row_tol)
F32_U = 2.0 ** -24


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# impute_example: the slices' cohort through the port's example
IMPUTE_UNITS, IMPUTE_MARKERS, IMPUTE_ITERS = 1000, 192, 4


# the script's start, for the elapsed seconds (t=) that every line ends
# with: the difference between two lines is what the phases between them
# took
START = time.perf_counter()


def say(phase, **kw):
    kw["t"] = f"{time.perf_counter() - START:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def release(tmp, phase, keep=()):
    """Deletes every file under ``tmp`` but those in ``keep`` (a later
    phase's inputs) and prints the bytes that the phase had left there:
    the CLI and example phases write hundreds of MB of tables and dumps,
    and each phase's files go once it has checked them."""
    left = 0
    for root, _, files in os.walk(tmp):
        for name in files:
            path = os.path.join(root, name)
            if path not in keep:
                left += os.path.getsize(path)
                os.remove(path)
    say(phase, tmp_bytes_released=left, kept_files=len(keep))


def wrappers():
    from cnf2freq_tpu_torch.ops import coherence as pcoh
    from cnf2freq_tpu_torch.ops import fb as pfb
    from cnf2freq_tpu_torch.ops import scan as ps
    from cnf2freq_tpu_torch.ops import stats as pst
    from cnf2freq_tpu_torch.updates import capped as pcap
    from cnf2freq_tpu_torch.updates import relskew as prs
    return {"emission": ps.emission, "fb_sweep": ps.fb_sweeps,
            "stats": pst.stats, "turn": ps.turn_weights,
            "fb_classic": pfb.fb_sweeps, "stats_bmns": pst.stats_pallas,
            "fb_sweep_init": ps.fb_sweeps, "fb_carry": ps.fb_carry,
            "stats_rules": pst.stats_rules,
            "stats_bmns_rules": pst.stats_bmns_rules,
            "fb_small": pfb.fb_sweeps_small,
            "fb_small_nohaplo": pfb.fb_sweeps_small,
            "fb_ext": pfb.fb_ext, "fb_ext_relskewstates": pfb.fb_ext,
            "fb_small_init": pfb.fb_small_block,
            "fb_small_carry": pfb.fb_small_carry,
            "fb_ext_init": pfb.fb_ext_block, "fb_ext_carry": pfb.fb_ext_carry,
            "capped_haplo": pcap.capped_haplo,
            "capped_infprob": pcap.capped_infprob,
            "relskew": prs.relskew_ratio, "coherence": pcoh.coherence}


def cuda_rounds(fn, rounds, reps, warm=True):
    """Milliseconds per launch of fn() in each of ``rounds`` rounds of
    ``reps`` launches, by CUDA events, after one warm-up call (none with
    ``warm=False``)."""
    if warm:
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
    version (100-700 ms, run just before for the comparison, so warm) in
    one call on either side."""
    p1 = cuda_rounds(plain, 1, 1, warm=False)
    k = cuda_rounds(kernel, 3, 20) + cuda_rounds(kernel, 3, 20)
    p2 = cuda_rounds(plain, 1, 1, warm=False)
    return k, (p1[0] + p2[0]) / 2


def bare_rounds(fn, rounds=6, reps=20):
    """Milliseconds of fn()'s device work per call, without the wrapper's
    Python: one CUDA graph of ``reps`` calls (captured after a warm-up on
    a side stream), replayed in ``rounds`` rounds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return [x / reps for x in cuda_rounds(graph.replay, rounds, 1)]


def nbytes(*xs):
    """Bytes of tensors (nested tuples allowed), each counted once."""
    total = 0
    for x in xs:
        if torch.is_tensor(x):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
    return total


def bound(name, moved, work, dtype, ops=None):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations (OPS[name] * work, or ``ops``) over the dtype's rate."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    rate = FP64_OPS_PER_S if dtype == torch.float64 else FP32_OPS_PER_S
    t_ops = (OPS[name] * work if ops is None else ops) / rate * 1e3
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


def as_accurate(ref64):
    """A compare() for float32 against float64 plain results ``ref64`` of
    the same (promoted) inputs: the max abs / rel errors are the kernel's
    against its float32 plain twin, ``ok`` is the ACCURACY_SLACK rule."""
    def cmp(got, ref, dtype):
        a, r, ok = compare_all(got, ref, dtype)
        if dtype == torch.float64:
            return a, r, ok
        rtol, atol = TOL[dtype]

        def worst(xs):
            return max(float(((x.double() - y).abs() /
                              (atol + rtol * y.abs())).max())
                       for x, y in zip(xs, ref64))
        wk, wp = worst(got), worst(ref)
        ok = all(torch.isfinite(g).all() for g in got) and \
            wk <= ACCURACY_SLACK * max(wp, 1.0)
        say("kernels", dtype="float32", accuracy_vs_float64_plain=True,
            kernel_worst_in_tol_units=f"{wk:.3f}",
            plain_worst_in_tol_units=f"{wp:.3f}", slack=ACCURACY_SLACK,
            ok=ok)
        return a, r, ok
    return cmp


def kernel_inputs(dtype, n_markers=192, spacing_cm=1.0, n_variants=1):
    """The slice's cohort on the card as a family batch, with randomised
    haploweights and error rates so every block branch is exercised, and
    ``n_variants`` probe-dedup variants."""
    from cnf2freq_tpu_torch.config import ModelConfig, RuntimeParams
    from cnf2freq_tpu_torch.hmm.family import gather_family
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    ped = simulate_f2(n_f2=1000, n_markers=n_markers,
                      marker_spacing_cm=spacing_cm, n_founder_pairs=20,
                      seed=7)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1,
                       n_variants=n_variants)
    rng = np.random.default_rng(7)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    fbt = fb.to("cuda", dtype)
    dists = torch.as_tensor(np.diff(ped.markerposes), dtype=dtype,
                            device="cuda")
    return fbt, dists, ModelConfig(), RuntimeParams()


@functools.lru_cache(maxsize=1)
def update_kernel_inputs():
    """The arguments of each update kernel's first call in one real
    update, on the card in float32: the slice's cohort (1000 x 192)
    through the default Driver's preprocess() and early iteration, which
    updates at the Driver's starting scalefactor (0.013); recorded as
    recording_updates records whole updates, copied."""
    from cnf2freq_tpu_torch import Driver, resident
    from cnf2freq_tpu_torch.updates import parameter_updates as pu
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    ped = simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20, seed=7)
    drv = Driver(ped, dtype=torch.float32, device="cuda")
    drv.preprocess()
    sites = {"capped_haplo": pu, "capped_infprob": pu, "relskew": resident}
    attrs = {"capped_haplo": "capped_haplo",
             "capped_infprob": "capped_infprob", "relskew": "relskew_ratio"}
    real = {k: getattr(m, attrs[k]) for k, m in sites.items()}
    seen = {}

    def recording(name):
        def call(*args):
            seen.setdefault(name, tuple(
                x.clone() if torch.is_tensor(x) else x for x in args))
            return real[name](*args)
        return call
    for k, m in sites.items():
        setattr(m, attrs[k], recording(k))
    try:
        drv.iterate(early=True)
    finally:
        for k, m in sites.items():
            setattr(m, attrs[k], real[k])
    torch.cuda.synchronize()
    return seen


def plain_lane_steps(reference, args):
    """``reference(*args)``, a capped entry's plain version, with the loop
    of capped.cappedgd re-run beside it on the same lanes, counting for
    each lane the steps in which it was not yet done (done lanes are
    frozen, so these are the steps its result needed): (the plain result,
    the steps per lane, in the entry's lane order).  The re-run must give
    the plain version's values and hits bit for bit."""
    from cnf2freq_tpu_torch.updates import capped as pc
    real, runs = pc.cappedgd, []

    def counting(gradient, orig, epsilon, scalefactor, breakathalf=False,
                 iters=pc.ITERS):
        sf = float(scalefactor)
        eps = epsilon.expand(orig.shape)
        brk = torch.as_tensor(breakathalf, device=orig.device).expand(
            orig.shape)

        def clip(x):
            return torch.minimum(torch.maximum(x, eps), 1.0 - eps)
        lolim, _ = pc.caplogitchange(eps, orig, eps, brk)
        hilim, _ = pc.caplogitchange(1.0 - eps, orig, eps, brk)
        origc, _ = pc.caplogitchange(orig, orig, eps, brk)
        g0 = 1.0 / gradient(clip(origc))
        done = ~torch.isfinite(g0) | pc.flat_lanes(g0) | (sf == 0)
        low = g0 < 0
        lo = torch.where(done | ~low, origc, lolim - eps * 0.125)
        hi = torch.where(done | low, origc, hilim + eps * 0.125)
        steps = torch.zeros(orig.shape, dtype=torch.int32, device=orig.device)
        for _ in range(iters if sf != 0.0 else 0):
            if bool(done.all()):
                break
            steps += (~done).int()
            done = done | (lo > hilim) | (hi < lolim)
            mid = 0.5 * (lo + hi)
            gv = 1.0 / gradient(clip(mid))
            bad = ((gv < 0) ^ low) | ~torch.isfinite(gv)
            start, end = torch.minimum(origc, mid), torch.maximum(origc, mid)
            done = done | (((end - start) < 1e-10) & ~bad)
            qm, qh = 0.5 * (start + end), 0.5 * (end - start)
            acc = torch.zeros_like(qm)
            for x, w in zip(pc._GL_X, pc._GL_W):
                acc = acc + float(w) / gradient(clip(qm + qh * float(x)))
            prel = acc * qh
            prel = torch.where(end != mid, -prel, prel)
            prel = torch.where(bad | ~torch.isfinite(prel), (sf + 0.1) * 1.1,
                               prel)
            done = done | ((prel - sf).abs() < sf * 1e-3)
            up = (prel < sf) ^ low
            lo = torch.where(done, lo, torch.where(up, mid, lo))
            hi = torch.where(done, hi, torch.where(up, hi, mid))
        runs.append((pc.caplogitchange(0.5 * (lo + hi), orig, eps, brk),
                     real(gradient, orig, epsilon, scalefactor, breakathalf,
                          iters), steps))
        return runs[-1][1]
    pc.cappedgd = counting
    try:
        out = reference(*args)
    finally:
        pc.cappedgd = real
    (mine, plain, steps), = runs
    if not all(torch.equal(a, b) for a, b in zip(mine, plain)):
        fail("plain_lane_steps: the counted loop departs from cappedgd")
    return out, steps


def compare_exact(got, ref, dtype):
    """compare()'s errors; ok only where the values (NaN where NaN) are the
    plain version's bit for bit."""
    a, r, _ = compare(got, ref, dtype)
    same = torch.equal(got.isnan(), ref.isnan()) and \
        torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0))
    return a, r, bool(same)


def compare_capped(got, ref, dtype):
    """compare()'s errors of the new values; ok only where the values (NaN
    where NaN) and the hits are the plain version's bit for bit."""
    a, r, _ = compare(got[0], ref[0], dtype)
    v, rv = got[0], ref[0]
    same = torch.equal(v.isnan(), rv.isnan()) and \
        torch.equal(v.nan_to_num(0.0), rv.nan_to_num(0.0))
    return a, r, bool(same and torch.equal(got[1], ref[1]))


def capped_divergence(name, dtype, lane_steps):
    """A capped entry's divergence factors on lanes of ``lane_steps``
    steps each (0 for a dead lane or one the kernel skips): the issue
    slots of the warps over the useful lane-steps, sum over warps of (its
    steps x 32) / lane-steps.  For one thread a lane, 32 consecutive lanes
    a warp, a warp's steps are its slowest lane's.  For the kernel's shared
    queue (its resident warps take the lanes in order, a thread the next
    one as soon as its own is done or dead, a step of a warp one slot
    however many of its threads step), they are modelled with every warp
    stepping in lockstep.  Returns (factor a lane, factor of the queue,
    the launch's threads)."""
    import ctypes

    from cnf2freq_tpu_torch import _build
    s = lane_steps.reshape(-1).long().cpu().numpy()
    threads = ctypes.c_int(0)
    fn = _build.load_kernels().cnf_capped_threads
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    err = fn(int(name == "capped_infprob"), int(dtype == torch.float64),
             len(s), ctypes.byref(threads))
    if err != 0:
        fail(f"{name}: cnf_capped_threads returned {err}")
    total = float(s.sum())
    by_lane = np.pad(s, (0, (-len(s)) % 32)).reshape(-1, 32).max(axis=1)
    rem = np.zeros((threads.value // 32, 32), dtype=np.int64)
    flat = rem.reshape(-1)
    taken, slots = 0, 0
    while True:
        while taken < len(s):
            free = np.flatnonzero(flat == 0)
            if len(free) == 0:
                break
            n = min(len(free), len(s) - taken)
            flat[free[:n]] = s[taken:taken + n]
            taken += n
        live = (rem > 0).any(axis=1)
        if not live.any():
            break
        slots += int(live.sum())
        rem -= rem > 0
    return float(by_lane.sum()) * 32 / total, slots * 32 / total, \
        threads.value


@functools.lru_cache(maxsize=None)
def capped_step_sass():
    """SASS instructions of one bisection step of each capped entry, from
    ``cuobjdump -sass`` of the built library: {(entry, type): count}.  A
    step's loop holds the evaluation loop (16 evaluations, as many a trip
    as csrc/capped.cu unrolls it) and the warp's lane-taking loop (VOTE);
    the count is the evaluation loop's instructions times its trips plus
    the step loop's other instructions.  Static counts of the fast path:
    the quotients' slow paths are calls out of the loops.  An entry whose
    loops are not found is left out (its line says "not measured")."""
    from cnf2freq_tpu_torch import _build
    lib = glob.glob(os.path.join(_build.build_dir(),
                                 "libcnf2freq_kernels_*.so"))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not lib or not os.path.exists(cuobjdump):
        return {}
    src = open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                            "capped.cu")).read()
    unroll = int(re.search(r"#pragma unroll (\d+)\n\s+for \(int k = 0; "
                           r"k <= kNodes", src).group(1))
    text = subprocess.run([cuobjdump, "-sass"] + lib, capture_output=True,
                          text=True, timeout=300).stdout
    out = {}
    for part in re.split(r"\n\s+Function : ", text)[1:]:
        m = re.search(r"capped_(haplo|infprob)_kernelI([fd])", part)
        if not m:
            continue
        ins = [(int(a, 16), t) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        loops = [(int(t, 16), a) for a, x in ins
                 for t in re.findall(r"\bBRA\b[^;]*?0x([0-9a-f]+)", x)
                 if int(t, 16) < a]

        def body(lo, hi):
            return [x for a, x in ins if lo <= a <= hi]

        def has(lo, hi, op):
            return any(op in x for x in body(lo, hi))
        evals = max((lp for lp in loops if not has(*lp, "VOTE")),
                    key=lambda lp: sum("MUFU" in x for x in body(*lp)),
                    default=None)
        take = evals and max((lp for lp in loops if lp[1] < evals[0] and
                              has(*lp, "VOTE")),
                             key=lambda lp: lp[1] - lp[0], default=None)
        step = take and min((lp for lp in loops if lp[0] <= take[0] and
                             lp[1] >= evals[1]),
                            key=lambda lp: lp[1] - lp[0], default=None)
        if step is None:
            continue
        n_evals, n_step, n_take = (len(body(*lp)) for lp in
                                   (evals, step, take))
        out[("capped_" + m.group(1),
             "float32" if m.group(2) == "f" else "float64")] = \
            n_evals * 16 // unroll + n_step - n_evals - n_take
    return out


def edge_update_lanes(dtype, M=16, seed=11):
    """Synthetic uniform lanes with the capped entries' and the relskew
    HMM's edges, on the card: {entry: arguments but the scalefactor}.
    capped_haplo rows: 0 at eps, 1 at 1 - eps, 2 flat (no count, neutral
    relskew, off 0.5 by a rounding-floor amount), 3 NaN gradients, 4 and 5
    breakathalf pulled across 0.5; capped_infprob rows: 0 at eps / 1 -
    eps, 1 flat (symmetric masses but for a rounding-floor amount, no
    prior), 2 a NaN mass (a NaN total beside it), about a fifth of the
    lanes without mass; relskew rows 0 and 1 rescaled, read as a column
    slice of wider tensors."""
    from cnf2freq_tpu_torch.config import RuntimeParams
    rng = np.random.default_rng(seed)
    N = 64
    flat = 1e-13 if dtype == torch.float64 else 2e-7
    children = rng.integers(0, 4, N).astype(float)
    eps = RuntimeParams().maxdiff / (children + 1.0)
    w = rng.uniform(0.02, 0.98, (N, M))
    C = rng.integers(0, 4, (N, M)).astype(float)
    B = C * rng.uniform(0, 1, (N, M))
    sim = rng.uniform(0, 0.99, (N, M))
    rel = rng.uniform(0.1, 0.9, (N, M))
    brk = rng.random((N, M)) < 0.3
    w[0], w[1] = eps[0], 1.0 - eps[1]
    w[2], C[2], B[2], rel[2], sim[2] = 0.5 + flat, 1.0, 0.5 + flat, 0.5, 1.0
    rel[3] = np.nan
    brk[4:6], w[4], w[5], C[4:6], B[4], B[5] = True, 0.49, 0.51, 4, 4, 0
    desc = rng.integers(1, 5, N).astype(float)
    cp = rng.uniform(0, 1, (N, M, 2, 2))
    a = rng.uniform(0, 2, (N, M, 2, 2))
    a[rng.random(a.shape) < 0.2] = 0.0
    prior = np.where(rng.random(a.shape) < 0.5, 0.0,
                     rng.uniform(-3, 3, a.shape))
    cp[0, ..., 0], cp[0, ..., 1] = eps[0], 1.0 - eps[0]
    cp[1], a[1, ..., 0], a[1, ..., 1], prior[1] = 0.5, 1.0 + flat, 1.0, 0.0
    a[2, ..., 0], a[2, ..., 1] = np.nan, 1.0
    t = a.sum(axis=-1, keepdims=True)
    hw = rng.uniform(0, 1, (N, M + 4))
    rh = rng.uniform(1e-4, 1 - 1e-4, (N, M + 4))
    alt = np.where(np.arange(M + 4) % 2 == 0, 1e-6, 1 - 1e-6)
    hw[0], hw[1], rh[0:2] = alt, 1.0 - alt, 1 - 1e-6

    def dev(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device="cuda")
    ef = RuntimeParams().entropyfactor
    return {"capped_haplo": tuple(dev(x) for x in (w, B, C, sim, rel, desc,
                                                   eps)) +
            (dev(brk, torch.bool), ef),
            "capped_infprob": tuple(dev(x) for x in (cp, a, t, prior, eps)) +
            (ef,),
            "relskew": (dev(hw)[:, 2:2 + M], dev(rh)[:, 2:2 + M])}


def check_update_kernels(dtype, record):
    """The update stage's kernels against their plain versions: timed on
    one real update of the slice's cohort (update_kernel_inputs, promoted
    to float64 for the float64 rows), the capped entries' bound reckoned
    from the lane-steps that the plain version took there; then compared
    on edge_update_lanes at the real update's scalefactor and at 0.
    Returns {name: edges ok}."""
    from cnf2freq_tpu_torch.updates import capped as pc
    from cnf2freq_tpu_torch.updates import relskew as prs
    w = wrappers()

    def cast(args):
        return tuple(x.to(dtype) if torch.is_tensor(x) and
                     x.is_floating_point() else x for x in args)
    real = {k: cast(v) for k, v in update_kernel_inputs().items()}
    plain = {"capped_haplo": pc.capped_haplo_reference,
             "capped_infprob": pc.capped_infprob_reference,
             "relskew": prs.relskew_ratio_reference}
    for name in ("capped_haplo", "capped_infprob"):
        args = real[name]
        got = w[name](*args)
        ref, steps = plain_lane_steps(plain[name], args)
        torch.cuda.synchronize()
        if name == "capped_infprob":
            # the kernel skips the lanes without mass
            live = (args[1] > 0).reshape(-1)
            lane_work = torch.where(live, steps, 0)
            steps = steps[live]
        else:
            lane_work = steps
        per_step, per_lane = CAPPED_OPS[name]
        lane_steps = int(steps.sum())
        by_lane, by_queue, threads = capped_divergence(name, dtype,
                                                       lane_work)
        say("kernels", dtype=str(dtype).split(".")[-1], kernel=name,
            scalefactor=args[-1], lanes=steps.numel(), lane_steps=lane_steps,
            steps_max=int(steps.max()), hits=int(ref[1].sum()),
            hits_kernel=int(got[1].sum()),
            divergence_lane_warps=f"{by_lane:.3f}",
            divergence_queue_modelled=f"{by_queue:.3f}",
            grid_threads=threads,
            sass_per_lane_step=capped_step_sass().get(
                (name, str(dtype).split(".")[-1]), "not measured"))
        record(name, got, ref, lambda: w[name](*args),
               lambda: plain[name](*args), nbytes(args, got), None,
               cmp=compare_capped,
               ops=per_step * lane_steps + per_lane * steps.numel())
        del got, ref
    hw, rh = real["relskew"]
    got = w["relskew"](hw, rh)
    record("relskew", got, plain["relskew"](hw, rh),
           lambda: w["relskew"](hw, rh), lambda: plain["relskew"](hw, rh),
           nbytes(hw, rh, got), hw.numel(), cmp=compare_exact, bare=True)
    del got
    scratch_ok = relskew_scratch_body(hw, rh, dtype)
    edges, ok = edge_update_lanes(dtype), {}
    sf = real["capped_haplo"][-1]
    for name, args in edges.items():
        cases = [()] if name == "relskew" else [(sf,), (0.0,)]
        res = [(compare_capped if name != "relskew" else compare_exact)(
            w[name](*args, *c), plain[name](*args, *c), dtype)
            for c in cases]
        ok[name] = all(r[2] for r in res)
        say("kernels", dtype=str(dtype).split(".")[-1], kernel=name,
            edge_lanes=True, scalefactors=[c[0] for c in cases if c],
            max_abs_err=f"{max(r[0] for r in res):.3e}", ok=ok[name])
    for name in ("capped_haplo", "capped_infprob"):
        ok[name] = ok[name] and capped_two_streams(name, real[name],
                                                   plain[name], dtype)
    ok["relskew"] = ok["relskew"] and scratch_ok
    return ok


def relskew_scratch_body(hw, rh, dtype, M=2048):
    """relskew at slice_blocked's shape, the real update's rows with their
    columns repeated to M markers, where the kernel keeps its stored
    states in a device scratch (fails if it would not): its ratios bit for
    bit the plain version's, and its bare time."""
    from cnf2freq_tpu_torch.updates import relskew as prs
    if not prs._needs_scratch(M, dtype):
        fail(f"relskew: {M} markers no longer take the scratch body")
    cols = torch.arange(M, device=hw.device) % hw.shape[1]
    hw, rh = hw[:, cols].contiguous(), rh[:, cols].contiguous()
    got = prs.relskew_ratio(hw, rh)
    a, _, ok = compare_exact(got, prs.relskew_ratio_reference(hw, rh), dtype)
    br = bare_rounds(lambda: prs.relskew_ratio(hw, rh))
    say("kernels", dtype=str(dtype).split(".")[-1], kernel="relskew",
        rows=hw.shape[0], markers=M, scratch_body=True,
        max_abs_err=f"{a:.3e}", bare_ms=f"{statistics.median(br):.4f}",
        bare_min=f"{min(br):.4f}", bare_max=f"{max(br):.4f}", ok=ok)
    return ok


def capped_two_streams(name, args, reference, dtype):
    """A capped entry launched on two streams with both launches in flight
    at once, on the real update's lanes and on the same rows reversed:
    each launch takes its lanes from a counter of its own, so both give
    the plain version's values and hits bit for bit."""
    flipped = tuple(x.flip(0) if torch.is_tensor(x) else x for x in args)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    fn = wrappers()[name]
    torch.cuda.synchronize()
    got = []
    for stream, a in zip(streams, (args, flipped)):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            got.append(fn(*a))
    torch.cuda.synchronize()
    same = [compare_capped(g, reference(*a), dtype)[2]
            for g, a in zip(got, (args, flipped))]
    say("kernels", dtype=str(dtype).split(".")[-1], kernel=name,
        two_streams=True, same_as_plain=same, ok=all(same))
    return all(same)


def check_kernels(dtype):
    """Each kernel vs its plain version; returns {name: record}."""
    from cnf2freq_tpu_torch.hmm import probes
    from cnf2freq_tpu_torch.hmm.emission import assemble_e_all, build_blocks
    from cnf2freq_tpu_torch.hmm.forward_backward import (FBResult,
                                                         combined_loglik)
    from cnf2freq_tpu_torch.hmm.transition import (interval_recomb,
                                                   transition_eigenvalues)
    from cnf2freq_tpu_torch.ops import fb as pfb
    from cnf2freq_tpu_torch.ops import scan as ps
    from cnf2freq_tpu_torch.ops import stats as pst
    fbt, dists, cfg, params = kernel_inputs(dtype,
                                            n_variants=PARITY_VARIANTS)
    st = ps.prep_slots(fbt, dtype)
    # the slot tensors that the entries without probe rules read
    slots = (st.md, st.ms, st.hw, st.ex, st.at, st.f2, st.sh)
    B, _, M, _ = fbt.md.shape
    out = {}

    def record(name, got, ref, kernel, plain, moved, work, cmp=compare,
               launches_per_call=1, ops=None, bare=False, **tol):
        a, r, ok = cmp(got, ref, dtype)
        rounds, p_ms = in_turns(plain, kernel)
        rounds = [x / launches_per_call for x in rounds]
        p_ms /= launches_per_call
        k_ms = statistics.median(rounds)
        b_ms, b_by = bound(name, moved, work, dtype, ops)
        out[name] = dict(max_abs_err=a, max_rel_err=r, ok=ok, ms=k_ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        if bare:  # the device work alone, a graph of the kernel's calls
            br = [x / launches_per_call for x in bare_rounds(kernel)]
            tol.update(bare_ms=f"{statistics.median(br):.4f}",
                       bare_min=f"{min(br):.4f}", bare_max=f"{max(br):.4f}")
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
           nbytes(slots, args[1:6], got), M * B, cmp=compare_all)

    # the probe-rule form: every variant checked, variant 1 timed (one
    # launch reads em and one df column)
    nv = PARITY_VARIANTS

    def plain_rules(v):
        return pst.stats_reference(*args, em=st.em, df=st.df[v], rules=True)
    got = [pst.stats_rules(st, v, *args[1:]) for v in range(nv)]
    record("stats_rules", [x for g in got for x in g],
           [x for v in range(nv) for x in plain_rules(v)],
           lambda: pst.stats_rules(st, 1, *args[1:]),
           lambda: plain_rules(1),
           nbytes(slots, st.em, st.df[1], args[1:6], got[1]), M * B,
           cmp=compare_all)
    del got

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
    blocks = build_blocks(fbt, cfg, dtype=dtype)
    e = assemble_e_all(blocks, cfg)
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
    bmns_slots = (fbt.md, fbt.ms, fbt.hw, fbt.exists.int(), fbt.attop.int(),
                  fbt.flag2ignore, fbt.shiftignore)
    record("stats_bmns", got, pst.stats_bmns_reference(*args),
           lambda: pst.stats_pallas(*args),
           lambda: pst.stats_bmns_reference(*args),
           nbytes(bmns_slots, args[1:6], got), M * B, cmp=compare_all)

    def plain_bmns_rules(v):
        return pst.stats_bmns_reference(*args, em=fbt.emptyslot,
                                        df=fbt.dup_flip[:, v], rules=True)
    got = [pst.stats_bmns_rules(fbt, v, *args[1:]) for v in range(nv)]
    record("stats_bmns_rules", [x for g in got for x in g],
           [x for v in range(nv) for x in plain_bmns_rules(v)],
           lambda: pst.stats_bmns_rules(fbt, 1, *args[1:]),
           lambda: plain_bmns_rules(1),
           nbytes(bmns_slots, fbt.emptyslot.int(), fbt.dup_flip[:, 1].int(),
                  args[1:6], got[1]), M * B, cmp=compare_all)
    del e, got, args
    torch.cuda.empty_cache()

    # the coherence of the same sweeps (csrc/coherence.cu); in float32
    # held to the plain twin's accuracy against float64 on the same
    # inputs promoted (C divides parity-signed chains by their total)
    coh_args = (fbres, blocks, fbt, cfg, lam)
    got = probes.phase_coherence(*coh_args)
    ref = probes.phase_coherence_reference(*coh_args)
    ref64 = [probes.phase_coherence_reference(
        FBResult(*(None if x is None else x.double() for x in fbres)),
        blocks._replace(froot=blocks.froot.double(),
                        pb=tuple(x.double() for x in blocks.pb)),
        fbt, cfg, lam.double())] if dtype == torch.float32 else None
    torch.cuda.synchronize()
    record("coherence", [got], [ref],
           lambda: probes.phase_coherence(*coh_args),
           lambda: probes.phase_coherence_reference(*coh_args),
           nbytes(fbres.fw_pre, fbres.bw, fbres.fw_pre_f, fbres.bw_f, lam,
                  blocks.froot, blocks.pb, fbt.flag2ignore, got),
           B * (M - 1), cmp=as_accurate(ref64))
    del fbc, fbres, blocks, got, ref, ref64, coh_args
    torch.cuda.empty_cache()

    # -- the marker-blocked scan's sweeps: one block of the blocked slice
    fbt, dists, cfg, params = kernel_inputs(dtype, BLOCK, 0.05)
    st = ps.prep_slots(fbt, dtype)
    K, R = BLOCK, st.R
    e = ps.emission(st, K, cfg)
    lam_pad = ps.sweep_eigenvalues(dists, cfg, params, dtype)
    gen = torch.Generator(device="cuda").manual_seed(9)

    def carry():
        return (torch.rand((512, R), generator=gen, device="cuda",
                           dtype=dtype),
                torch.randn((8, R), generator=gen, device="cuda",
                            dtype=dtype) * 3)
    init_fwd, init_bwd, below = carry(), carry(), lam_pad[K // 2]
    kw = dict(lam_pad=lam_pad, init_fwd=init_fwd, init_bwd=init_bwd)
    got = ps.fb_sweeps(e, None, cfg, None, **kw)
    ref = ps.fb_scan_v2_block(e, lam_pad, *init_fwd, *init_bwd, cfg)
    e64, lam64, below64 = e.double(), lam_pad.double(), below.double()
    fwd64, bwd64 = (tuple(x.double() for x in c) for c in (init_fwd,
                                                         init_bwd))
    ref64 = ps.fb_scan_v2_block(e64, lam64, *fwd64, *bwd64, cfg)
    torch.cuda.synchronize()
    record("fb_sweep_init", got, ref,
           lambda: ps.fb_sweeps(e, None, cfg, None, **kw),
           lambda: ps.fb_scan_v2_block(e, lam_pad, *init_fwd, *init_bwd,
                                       cfg),
           nbytes(e, lam_pad, init_fwd, init_bwd, tuple(got)), R * 8 * K,
           cmp=as_accurate(ref64))
    del got, ref, ref64

    def carries():
        return (ps.fb_carry(e, lam_pad, cfg, init=init_fwd) +
                ps.fb_carry(e, lam_pad, cfg, init=init_bwd, backward=True,
                            lam_below=below))

    def plain_carries():
        return (ps.fb_carry_fwd(e, lam_pad, *init_fwd, cfg) +
                ps.fb_carry_bwd(e, lam_pad, below, *init_bwd, cfg))
    got = carries()
    ref64 = (ps.fb_carry_fwd(e64, lam64, *fwd64, cfg) +
             ps.fb_carry_bwd(e64, lam64, below64, *bwd64, cfg))
    # one launch moves e, the eigenvalue rows and one carry in and out
    record("fb_carry", got, plain_carries(), carries, plain_carries,
           nbytes(e, lam_pad, init_fwd, got[:2]), R * 8 * K,
           cmp=as_accurate(ref64), launches_per_call=2, bare=True)
    del e, got, ref64, e64
    torch.cuda.empty_cache()

    # -- the 4-state sweeps of the two-generation families, at the
    # emissions and eigenvalues their slices give them (1000 x 192)
    for name, model in (("fb_small", "ng2"), ("fb_small_nohaplo",
                                              "nohaplo")):
        e, lam = family_sweep_inputs(model, dtype)
        got = pfb.fb_sweeps_small(e, lam)
        ref = pfb.fb_sweeps_reference(e, lam, pfb.XLA_CLIP)
        torch.cuda.synchronize()
        B, M, NS, _ = e.shape
        record(name, got, ref, lambda: pfb.fb_sweeps_small(e, lam),
               lambda: pfb.fb_sweeps_reference(e, lam, pfb.XLA_CLIP),
               nbytes(e, lam, got), B * NS * M, cmp=compare_all,
               NS=NS)
        del e, got, ref
    torch.cuda.empty_cache()

    # -- the extended sweeps at the selfing (V = 3) and relskewstates
    # (V = 2) slices' inputs (1000 x 192)
    for name, model in (("fb_ext", "selfing"),
                        ("fb_ext_relskewstates", "relskewstates")):
        args = ext_sweep_inputs(model, dtype)
        got = pfb.fb_ext(*args)
        ref = pfb.fb_ext_reference(*args)
        torch.cuda.synchronize()
        B, M, V, NS, _ = args[0].shape
        record(name, got, ref, lambda: pfb.fb_ext(*args),
               lambda: pfb.fb_ext_reference(*args),
               nbytes(args, got), B * NS * M, cmp=compare_all, V=V)
        del args, got, ref
        torch.cuda.empty_cache()

    # -- the families' marker-blocked entries: one block (K = BLOCK) of the
    # blocked slices' cohorts, random boundary carries; in float32 held to
    # the plain twin's accuracy against float64 (0.1 cM: as_accurate)
    for model, kinit, kcarry in (("ng2", "fb_small_init", "fb_small_carry"),
                                 ("selfing", "fb_ext_init",
                                  "fb_ext_carry")):
        x64 = _blocked_family_inputs64(model)
        x = {k: v.to(dtype) for k, v in x64.items()}
        e, lam, below = x["e"], x["lam"], x["lam_below"]
        B, K, NS = e.shape[0], e.shape[1], e.shape[-2]
        gen = torch.Generator(device="cuda").manual_seed(9)

        def carry():
            return (torch.rand(e[:, 0].shape, generator=gen, device="cuda",
                               dtype=dtype),
                    torch.randn((B, NS), generator=gen, device="cuda",
                                dtype=dtype) * 3)
        fwd, bwd = carry(), carry()
        fwd64, bwd64 = (tuple(t.double() for t in c) for c in (fwd, bwd))
        clip = pfb.XLA_CLIP
        if model == "ng2":
            def init(fwd=fwd, bwd=bwd):
                return pfb.fb_small_block(e, lam, fwd, bwd)

            def plain_init(x=x, fwd=fwd, bwd=bwd):
                return pfb.fb_block_reference(x["e"], x["lam"], *fwd, *bwd,
                                              clip)

            def carries(fwd=fwd, bwd=bwd):
                return (pfb.fb_small_carry(e, lam, fwd) +
                        pfb.fb_small_carry(e, lam, bwd, backward=True,
                                           lam_below=below))

            def plain_carries(x=x, fwd=fwd, bwd=bwd):
                return (pfb.fb_carry_reference(x["e"], x["lam"], *fwd, clip)
                        + pfb.fb_carry_reference(
                            x["e"], x["lam"], *bwd, clip, backward=True,
                            lam_below=x["lam_below"]))
            ref64_init = plain_init(x64, fwd64, bwd64)
            ref64_carry = plain_carries(x64, fwd64, bwd64)
            extra = dict(NS=NS)
        else:
            C, C_below = x["C"], x["C_below"]

            def init(fwd=fwd, bwd=bwd):
                return pfb.fb_ext_block(e, lam, C, fwd, bwd)

            def plain_init(x=x, fwd=fwd, bwd=bwd):
                return pfb.fb_ext_block_reference(x["e"], x["lam"], x["C"],
                                                  *fwd, *bwd, clip)

            def carries(fwd=fwd, bwd=bwd):
                return (pfb.fb_ext_carry(e, lam, C, fwd) +
                        pfb.fb_ext_carry(e, lam, C, bwd, backward=True,
                                         lam_below=below, C_below=C_below))

            def plain_carries(x=x, fwd=fwd, bwd=bwd):
                return (pfb.fb_ext_carry_reference(x["e"], x["lam"], x["C"],
                                                   *fwd, clip) +
                        pfb.fb_ext_carry_reference(
                            x["e"], x["lam"], x["C"], *bwd, clip,
                            backward=True, lam_below=x["lam_below"],
                            C_below=x["C_below"]))
            ref64_init = plain_init(x64, fwd64, bwd64)
            ref64_carry = plain_carries(x64, fwd64, bwd64)
            extra = dict(V=e.shape[2])
        got = init()
        torch.cuda.synchronize()
        record(kinit, got, plain_init(), init, plain_init,
               nbytes(e, lam, x.get("C"), fwd, bwd, got), B * NS * K,
               cmp=as_accurate(ref64_init), K=K, **extra)
        del got, ref64_init
        got = carries()
        # one launch reads e, the interval rows and one carry, and writes
        # the outgoing carry
        record(kcarry, got, plain_carries(), carries, plain_carries,
               nbytes(e, lam, x.get("C"), fwd, got[:2]), B * NS * K,
               cmp=as_accurate(ref64_carry), launches_per_call=2, K=K,
               **extra)
        del got, ref64_carry, x, e
        torch.cuda.empty_cache()

    # -- the update stage (capped.cu, relskew.cu)
    for name, edges_ok in check_update_kernels(dtype, record).items():
        out[name]["ok"] = out[name]["ok"] and edges_ok
    torch.cuda.empty_cache()
    return out


def family_ped(model, n_f2=1000, n_markers=192, n_founder_pairs=20, seed=7,
               typed_parents=False, spacing_cm=1.0):
    """The slice's cohort under a two-generation family's config (the
    CLI's --model), founder flags cleared for the deep-walk family (the
    reference's no-haplotyping fixtrees sets none), as the JAX package's
    tests and its perf row for these families build it.  There the F1
    parents carry no genotypes, so under ng2 fixtrees marks every F2 unit
    a founder and its emission is the same in every state;
    ``typed_parents`` gives the F1 parents their simulated genotypes
    (error rate 0.02), so that the units are not founders.  ``selfing``
    is simulate_selfed(n_lines=n_f2, n_markers, generations=4,
    marker_spacing_cm=spacing_cm, seed), the selfed cohort of the JAX
    package's extended perf row (bench/ext_perf.py) at the default 1 cM
    (``spacing_cm`` spaces the markers of either)."""
    from cnf2freq_tpu_torch.cli import model_config
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2, simulate_selfed
    if model == "selfing":
        return simulate_selfed(n_lines=n_f2, n_markers=n_markers,
                               generations=4, marker_spacing_cm=spacing_cm,
                               seed=seed)
    ped = simulate_f2(n_f2=n_f2, n_markers=n_markers,
                      marker_spacing_cm=spacing_cm,
                      n_founder_pairs=n_founder_pairs, seed=seed)
    ped.config = model_config(model)
    if ped.config.deep_walk:
        for ind in ped.inds[1:]:
            ind.founder = False
    if typed_parents:
        for ind in ped.inds[1:]:
            if ind.empty and ind.n in ped.truths:
                ind.markerdata[:] = ped.truths[ind.n]
                ind.markersure[:] = 0.02
                ind.empty = False
    return ped


def family_sweep_inputs(model, dtype):
    """(e [1000, 192, NS, 4], lam [191, 4]) of a family's slice cohort on
    the card (F1 parents typed, so that the ng2 emissions differ between
    states), with randomised haploweights and error rates as
    kernel_inputs makes them: its engine's emission (plain PyTorch, in
    float64) and the transition eigenvalues, in ``dtype``."""
    e, lam = _family_sweep_inputs64(model)
    return e.to(dtype), lam.to(dtype)


@functools.lru_cache(maxsize=2)
def _family_sweep_inputs64(model):
    from cnf2freq_tpu_torch.config import RuntimeParams
    from cnf2freq_tpu_torch.hmm.family import gather_family
    from cnf2freq_tpu_torch.hmm.transition import (interval_recomb,
                                                   transition_eigenvalues)
    dtype = torch.float64
    ped = family_ped(model, typed_parents=True)
    cfg = ped.config
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1)
    rng = np.random.default_rng(7)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    fbt = fb.to("cuda", dtype)
    if cfg.deep_walk:
        from cnf2freq_tpu_torch.engine_nohaplo import nohaplo_emission
        e = nohaplo_emission(fbt, cfg, ci=True, dtype=dtype)
    else:
        from cnf2freq_tpu_torch.engine_ng2 import assemble_e_ng2, ng2_blocks
        e = assemble_e_ng2(*ng2_blocks(fbt, cfg, dtype=dtype), fbt, cfg)
    dists = torch.as_tensor(np.diff(ped.markerposes), dtype=dtype,
                            device="cuda")
    lam = transition_eigenvalues(cfg, interval_recomb(cfg, RuntimeParams(),
                                                      dists)).to(dtype)
    return e.contiguous(), lam


def ext_sweep_inputs(model, dtype):
    """(e [1000, 192, V, 8, 64], lam [191, 64], C [1000, 191, V, V],
    prior [1000, V]) of an extended slice's cohort (ext_ped) on the card,
    with randomised haploweights and error rates as kernel_inputs makes
    them and, under relskewstates, relhaplo drawn from U(0.2, 0.95) so
    that the coupling is not flat: the engine's emissions (plain PyTorch,
    in float64), eigenvalues, coupling and prior, in ``dtype``."""
    return tuple(x.to(dtype) for x in _ext_sweep_inputs64(model))


@functools.lru_cache(maxsize=2)
def _ext_sweep_inputs64(model):
    from cnf2freq_tpu_torch import engine_ext as E
    from cnf2freq_tpu_torch.config import RuntimeParams
    from cnf2freq_tpu_torch.hmm.family import gather_family
    dtype = torch.float64
    ped = ext_ped(model)
    cfg, params = ped.config, RuntimeParams()
    rng = np.random.default_rng(7)
    if cfg.relskewstates:
        for ind in ped.inds[1:]:
            if ind.relhaplo is not None:
                ind.relhaplo[:] = rng.uniform(0.2, 0.95, ind.relhaplo.shape)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1,
                       n_variants=1)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    fbt = fb.to("cuda", dtype)
    _, e, _, _ = E.ext_blocks(fbt, cfg, dtype=dtype)
    dists = torch.as_tensor(np.diff(ped.markerposes), dtype=dtype,
                            device="cuda")
    return (e.contiguous(), E._lam(cfg, params, dists, dtype),
            E._vcoupling(fbt, cfg, params, dists, dtype).contiguous(),
            E._prior(fbt, cfg, dtype))


def ext_ped(model, n_units=1000, n_markers=192, seed=None):
    """An extended slice's cohort: simulate_selfed(n_lines=1000,
    n_markers=192, generations=4, marker_spacing_cm=1.0, seed=3) under
    SELFING, or simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20,
    seed=7) under RELSKEWSTATES (the JAX package's extended perf rows,
    bench/ext_perf.py:54-62)."""
    if seed is None:
        seed = 3 if model == "selfing" else 7
    return family_ped(model, n_f2=n_units, n_markers=n_markers, seed=seed)


@functools.lru_cache(maxsize=2)
def _blocked_family_inputs64(model):
    """One block of a family's blocked slice cohort on the card, in
    float64: {e [1000, BLOCK, ...], lam [BLOCK, S], lam_below [S] and, on
    the extended spaces, C [1000, BLOCK, V, V], C_below [1000, V, V]}, from
    family_blocked_ped's cohort cut to BLOCK + 1 markers (weights
    randomised as kernel_inputs makes them); the interval below is the
    block's middle one."""
    from cnf2freq_tpu_torch import blocked_families as PB
    from cnf2freq_tpu_torch.config import RuntimeParams
    from cnf2freq_tpu_torch.hmm.family import gather_family
    ped = family_blocked_ped(model, n_markers=BLOCK + 1)
    cfg = ped.config
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1,
                       n_variants=1)
    rng = np.random.default_rng(7)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    fbt = fb.to("cuda", torch.float64)
    dists = torch.as_tensor(np.diff(ped.markerposes), dtype=torch.float64,
                            device="cuda")
    lam_pad, C_pad = PB.prep_intervals(fbt, dists, None, cfg,
                                       RuntimeParams())
    _, e = PB.block_emission(fbt, cfg, BLOCK + 1)
    mid = BLOCK // 2
    out = dict(e=e[:, :BLOCK].contiguous(), lam=lam_pad[:BLOCK].contiguous(),
               lam_below=lam_pad[mid].contiguous())
    if C_pad is not None:
        out.update(C=C_pad[:, :BLOCK].contiguous(),
                   C_below=C_pad[:, mid].contiguous())
    return out


def family_blocked_ped(model, n_markers=FAMILY_BLOCKED_MARKERS):
    """A family's blocked slice cohort: family_ped at 1000 units (lines)
    and FAMILY_BLOCKED_SPACING cM (the ng2 F1 parents typed)."""
    return family_ped(model, n_markers=n_markers,
                      spacing_cm=FAMILY_BLOCKED_SPACING,
                      seed=3 if model == "selfing" else 7,
                      typed_parents=model == "ng2")


@contextlib.contextmanager
def sync_counter(sites):
    """Count, into the Counter ``sites`` by file:line, the calls that
    synchronise the host with the card while active (PyTorch's sync debug
    mode reports each as a warning)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            sites[f"{os.path.basename(w.filename)}:{w.lineno}"] += 1


def check_update_launches(phase, launches, updates, chromosomes):
    """Each update launches each capped entry once and the relskew HMM
    once a chromosome."""
    want = {"capped_haplo": updates, "capped_infprob": updates,
            "relskew": updates * chromosomes}
    got = {k: launches[k] for k in want}
    say(phase, update_launches=json.dumps(got), updates=updates,
        chromosomes=chromosomes)
    if got != want:
        fail(f"{phase}: update kernel launches {got}, expected {want}")


def check_no_capped_syncs(phase, sites):
    """The capped bisection runs on the card: no synchronising call of a
    full iteration lies in updates/capped.py."""
    capped = {k: v for k, v in sites.items() if k.startswith("capped.py:")}
    say(phase, capped_py_syncs=json.dumps(capped),
        full_iteration_sites=json.dumps(sites.most_common()))
    if capped:
        fail(f"{phase}: a full iteration synchronised in capped.py: "
             f"{capped}")


def other_launches(w, mine):
    """The launches of the kernels in ``w`` that are neither in ``mine``
    nor of the update stage (which runs on every path that moves
    parameters)."""
    return {k: fn.launches for k, fn in w.items()
            if k not in mine and k not in UPDATE_KERNELS and fn.launches}


def run_slice(phase, adaptive, tracer=False, **driver_attrs):
    """The slice at 1000 x 192 in float32 through Driver.preprocess() and
    Driver.iterate(), with ``driver_attrs`` set on the Driver and, with
    ``tracer``, a live Tracer on it (its span split of each full iteration
    printed: host clock, unsynchronised); returns the launch counts of the
    kernels of its pipeline, read just after the run, and the
    synchronising calls of its full iterations."""
    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    from cnf2freq_tpu_torch.utils.tracing import Tracer
    ped = simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20, seed=7)
    rh0 = np.stack([ind.relhaplo for ind in ped.inds[1:]]).copy()
    drv = Driver(ped, dtype=torch.float32, device="cuda",
                 adaptive_relhaplo=adaptive)
    for k, v in driver_attrs.items():
        setattr(drv, k, v)
    sink = io.StringIO()
    if tracer:
        drv.tracer = Tracer(sink=sink)
    pipeline = "classic" if adaptive else "v2"
    wr = {k: fn for k, fn in wrappers().items()
          if KERNELS[k][2] in (pipeline, "update")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers().values():
        fn.launches = 0
    stages = [("preprocess", drv.preprocess),
              ("iterate_early", lambda: drv.iterate(early=True)),
              ("iterate_1", drv.iterate), ("iterate_2", drv.iterate)]
    full_syncs, sites = 0, collections.Counter()
    for name, fn in stages:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        here = collections.Counter()
        with sync_counter(here):
            out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        syncs = sum(here.values())
        if name.startswith("iterate_") and name != "iterate_early":
            full_syncs += syncs
            sites.update(here)
        extra = {} if out is None else dict(
            loglik=f"{out['loglik']:.6f}", hitnnn=out["hitnnn"],
            scalefactor=f"{out['scalefactor']:.6g}",
            inverted=out["inverted"])
        say(phase, stage=name, seconds=f"{sec:.3f}", syncs=syncs, **extra)
        if out is not None and not math.isfinite(out["loglik"]):
            fail(f"{phase}: non-finite log-likelihood after {name}")
    launches = {k: fn.launches for k, fn in wr.items()}
    peak = torch.cuda.max_memory_allocated()
    hw = np.stack([ind.haploweight for ind in ped.inds[1:]])
    rh = np.stack([ind.relhaplo for ind in ped.inds[1:]])
    tabs = np.stack(list(drv.pair_tables.values()))
    finite = bool(np.isfinite(hw).all() and np.isfinite(tabs).all()
                  and np.isfinite(rh).all())
    hw_ok = bool((hw >= 0).all() and (hw <= 1).all())
    moved = int((rh != rh0).sum())
    say(phase, resident=drv._use_resident(), flip_mode=drv.flip_mode,
        parent_swap=drv.parent_swap, launches=json.dumps(launches),
        finite=finite, haploweights_in_range=hw_ok,
        pair_tables=len(drv.pair_tables), relhaplo_moved=moved,
        relhaplo_min=f"{rh.min():.6g}", relhaplo_max=f"{rh.max():.6g}",
        peak_memory_gb=f"{peak / 1e9:.3f}")
    say(phase, full_iteration_syncs=full_syncs,
        per_full_iteration=f"{full_syncs / 2:.1f}",
        top_sites=json.dumps(sites.most_common(8)))
    if tracer:
        for split in trace_split(sink.getvalue()):
            say(phase, tracer="host clock, unsynchronised", **split)
    if not (finite and hw_ok):
        fail(f"{phase}: non-finite or out-of-range outputs")
    if min(launches.values()) <= 0:
        fail(f"{phase}: a kernel of the path never launched: {launches}")
    check_update_launches(phase, launches, updates=3,
                          chromosomes=ped.num_chromosomes)
    check_no_capped_syncs(phase, sites)
    if adaptive:
        # one coherence launch a chunk scan, as the classic statistics
        if launches["coherence"] != launches["stats_bmns"]:
            fail(f"{phase}: coherence launches {launches['coherence']}, "
                 f"stats_bmns {launches['stats_bmns']}")
        if moved == 0:
            fail(f"{phase}: no relhaplo moved from its loaded value")
        if rh.min() < RELHAPLO_CLIP or rh.max() > 1 - RELHAPLO_CLIP:
            fail(f"{phase}: relhaplo outside [1e-4, 1 - 1e-4]")
    elif moved:
        fail(f"{phase}: relhaplo moved with adaptive relhaplo off")
    return launches, full_syncs


def trace_split(text):
    """A Tracer's JSON lines cut after ``preprocess`` and at each
    ``iteration`` record: for each part, the seconds of its spans (host
    clock, unsynchronised), top-level spans first, and for an iteration
    its record's inverted flag."""
    out, cur = [], collections.Counter()

    def part(**kw):
        order = sorted(cur.items(), key=lambda kv: (kv[0].count("/"), -kv[1]))
        out.append(dict(kw, spans=json.dumps({k: round(v, 4)
                                              for k, v in order})))
        cur.clear()
    for line in text.splitlines():
        rec = json.loads(line)
        if rec["type"] == "span":
            cur[rec["name"]] += rec["seconds"]
            if rec["name"] == "preprocess":
                part(stage="preprocess")
        elif rec.get("event") == "iteration":
            part(stage=f"iteration_{rec['iter']}", inverted=rec["inverted"])
    return out


def run_slice_blocked():
    """The marker-blocked slice: 1000 x 2048 markers in float32 through
    the default Driver with marker_block=BLOCK; returns the launches of
    the blocked path's kernels."""
    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.profile_slice import stage_timers
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    M = 2048
    ped = simulate_f2(n_f2=1000, n_markers=M, marker_spacing_cm=0.05,
                      n_founder_pairs=20, seed=7)
    rh0 = np.stack([ind.relhaplo for ind in ped.inds[1:]]).copy()
    drv = Driver(ped, dtype=torch.float32, device="cuda")
    drv.marker_block = BLOCK
    nblk = -(-M // BLOCK)
    w = wrappers()
    names = ("emission", "fb_sweep_init", "fb_carry", "stats",
             "turn", "coherence") + UPDATE_KERNELS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in w.values():
        fn.launches = 0
    peaks = {}
    with stage_timers() as acc:
        for name, fn in (("preprocess", drv.preprocess),
                         ("iterate_early", lambda: drv.iterate(early=True)),
                         ("iterate_1", drv.iterate)):
            acc.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            passes = {k.split(".")[1]: v for k, v in acc.items()
                      if k.startswith("blocked.")}
            rest = sec - sum(passes.values())
            extra = {} if out is None else dict(
                loglik=f"{out['loglik']:.6f}", hitnnn=out["hitnnn"],
                inverted=out["inverted"])
            say("slice_blocked", stage=name, seconds=f"{sec:.3f}",
                **{f"{k}_s": f"{v:.3f}" for k, v in sorted(passes.items())},
                rest_s=f"{rest:.3f}", **extra)
            if out is not None and not math.isfinite(out["loglik"]):
                fail(f"slice_blocked: non-finite log-likelihood after {name}")
            if name == "preprocess":
                peaks["preprocess"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
    peaks["iterations"] = torch.cuda.max_memory_allocated()
    launches = {k: w[k].launches for k in names}
    hw = np.stack([ind.haploweight for ind in ped.inds[1:]])
    rh = np.stack([ind.relhaplo for ind in ped.inds[1:]])
    tabs = np.stack(list(drv.pair_tables.values()))
    finite = bool(np.isfinite(hw).all() and np.isfinite(tabs).all()
                  and np.isfinite(rh).all())
    moved = int((rh != rh0).sum())
    # one batch chunk: pass C launches the sweep once per block and
    # iteration, passes A and B the carry once per block each
    chunks = launches["fb_sweep_init"] / (2 * nblk)
    say("slice_blocked", markers=M, block=BLOCK, blocks=nblk,
        resident=drv._use_resident(), launches=json.dumps(launches),
        batch_chunks=chunks, finite=finite, relhaplo_moved=moved,
        peak_memory_gb_preprocess=f"{peaks['preprocess'] / 1e9:.3f}",
        peak_memory_gb_iterations=f"{peaks['iterations'] / 1e9:.3f}",
        limit_gb=f"{BLOCKED_PEAK_LIMIT / 1e9:.0f}")
    if min(launches.values()) <= 0:
        fail(f"slice_blocked: a kernel of the path never launched: "
             f"{launches}")
    if chunks != 1 or launches["fb_carry"] != 2 * launches["fb_sweep_init"]:
        fail(f"slice_blocked: the cohort did not run as one batch chunk: "
             f"{launches}")
    # coherence: one launch a block and one a block boundary, in each of
    # the two iterations
    if launches["coherence"] != 2 * (2 * nblk - 1):
        fail(f"slice_blocked: coherence launches {launches['coherence']}, "
             f"expected {2 * (2 * nblk - 1)}")
    check_update_launches("slice_blocked", launches, updates=2,
                          chromosomes=ped.num_chromosomes)
    if max(peaks.values()) >= BLOCKED_PEAK_LIMIT:
        fail(f"slice_blocked: peak memory {max(peaks.values()) / 1e9:.3f} "
             f"GB")
    if not finite or moved == 0:
        fail("slice_blocked: non-finite outputs or no relhaplo moved")
    return launches


def run_slice_blocked_family(model):
    """A family's marker-blocked slice (family_blocked_ped: 1000 x 1024 at
    0.1 cM) in float32 through the default Driver with marker_block=BLOCK:
    preprocess(), iterate(early=True), iterate(), with the blocked_fam.*
    split (synchronised) and the peak memory of preprocess and of the
    iterations; fails on more than one batch chunk, a blocked entry of
    the family at 0 launches, any other kernel launched, a non-finite
    output, a haploweight outside [0, 1] or a peak at or above
    FAMILY_BLOCKED_PEAK_LIMIT.  Returns the blocked entries' launches."""
    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.profile_slice import stage_timers
    phase = f"slice_blocked_{model}"
    names = ("fb_small_init", "fb_small_carry") if model == "ng2" else \
        ("fb_ext_init", "fb_ext_carry")
    ped = family_blocked_ped(model)
    M = ped.num_markers
    nblk = -(-M // BLOCK)
    drv = Driver(ped, dtype=torch.float32, device="cuda")
    drv.marker_block = BLOCK
    w = wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in w.values():
        fn.launches = 0
    peaks = {}
    with stage_timers() as acc:
        for name, fn in (("preprocess", drv.preprocess),
                         ("iterate_early", lambda: drv.iterate(early=True)),
                         ("iterate_1", drv.iterate)):
            acc.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            split = {k: round(v, 3) for k, v in sorted(
                acc.items(), key=lambda kv: -kv[1])}
            extra = {} if out is None else dict(
                loglik=f"{out['loglik']:.6f}", hitnnn=out["hitnnn"],
                inverted=out["inverted"])
            say(phase, stage=name, seconds=f"{sec:.3f}",
                split=json.dumps(split), **extra)
            if out is not None and not math.isfinite(out["loglik"]):
                fail(f"{phase}: non-finite log-likelihood after {name}")
            if name == "preprocess":
                peaks["preprocess"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
    peaks["iterations"] = torch.cuda.max_memory_allocated()
    launches = {k: w[k].launches for k in names}
    others = other_launches(w, names)
    updates = {k: w[k].launches for k in UPDATE_KERNELS}
    hw = np.stack([ind.haploweight for ind in ped.inds[1:]])
    tabs = np.stack(list(drv.pair_tables.values()))
    finite = bool(np.isfinite(hw).all() and np.isfinite(tabs).all())
    hw_ok = bool((hw >= 0).all() and (hw <= 1).all())
    # per chunk and iteration: pass C one seeded launch a block, passes A
    # and B one carry-only launch a block (B skips block 0)
    chunks = launches[names[0]] / (2 * nblk)
    say(phase, markers=M, block=BLOCK, blocks=nblk,
        n_variants=drv._n_variants(), resident=drv._use_resident(),
        launches=json.dumps(launches), update_launches=json.dumps(updates),
        other_kernel_launches=json.dumps(others), batch_chunks=chunks,
        finite=finite,
        haploweights_in_range=hw_ok,
        peak_memory_gb_preprocess=f"{peaks['preprocess'] / 1e9:.3f}",
        peak_memory_gb_iterations=f"{peaks['iterations'] / 1e9:.3f}",
        limit_gb=f"{FAMILY_BLOCKED_PEAK_LIMIT / 1e9:.0f}")
    if min(launches.values()) <= 0:
        fail(f"{phase}: a blocked entry never launched: {launches}")
    if others:
        fail(f"{phase}: another kernel launched: {others}")
    if min(updates[k] for k in ("capped_haplo", "capped_infprob")) <= 0:
        fail(f"{phase}: a capped entry never launched: {updates}")
    if chunks != 1 or launches[names[1]] != 2 * (2 * nblk - 1):
        fail(f"{phase}: the cohort did not run as one batch chunk: "
             f"{launches}")
    if max(peaks.values()) >= FAMILY_BLOCKED_PEAK_LIMIT:
        fail(f"{phase}: peak memory {max(peaks.values()) / 1e9:.3f} GB")
    if not (finite and hw_ok):
        fail(f"{phase}: non-finite or out-of-range outputs")
    return launches


def run_blocked_parity(model="f2", n_units=1000, block=32):
    """``n_units`` x 192 on the card in float64: marker_block=``block``
    against the unblocked Driver, one full iteration, at the CPU tests'
    tolerances; ``model`` a family of family_ped (the ng2 F1 parents
    typed)."""
    from cnf2freq_tpu_torch import Driver, copy_pedigree
    base = family_ped(model, n_f2=n_units, n_markers=192,
                      typed_parents=model == "ng2",
                      seed=3 if model == "selfing" else 7)
    peds = [copy_pedigree(base) for _ in range(2)]
    drvs = [Driver(p, dtype=torch.float64, device="cuda",
                   adaptive_relhaplo=False) for p in peds]
    drvs[0].marker_block = block
    t0 = time.perf_counter()
    for d in drvs:
        d.resident = False
        d.preprocess()
        d.iterate(early=False)
    hw_ok, calls_ok, hw_err = True, True, 0.0
    for a, b in zip(peds[0].inds[1:], peds[1].inds[1:]):
        hw_ok &= bool(np.allclose(a.haploweight, b.haploweight, rtol=1e-8,
                                  atol=1e-11))
        hw_err = max(hw_err, float(np.abs(a.haploweight -
                                          b.haploweight).max()))
        mism = a.markerdata != b.markerdata
        if mism.any():
            calls_ok &= bool((np.minimum(a.markersure[mism],
                                         b.markersure[mism]) > 0.4).all())
    tabs = [d.pair_tables for d in drvs]
    pair_ok = all(np.allclose(tabs[0][n], tabs[1][n], rtol=1e-8, atol=1e-11)
                  for n in tabs[1])
    pair_err = max(float(np.abs(tabs[0][n] - tabs[1][n]).max())
                   for n in tabs[1])
    ok = hw_ok and calls_ok and pair_ok
    say("blocked_parity", model=model, units=n_units, marker_block=block,
        seconds=
        f"{time.perf_counter() - t0:.3f}", haploweight_max_abs=f"{hw_err:.3e}",
        pair_max_abs=f"{pair_err:.3e}", rtol=1e-8, atol=1e-11,
        calls_equal_but_near_ties=calls_ok, ok=ok)
    if not ok:
        fail(f"blocked and unblocked float64 runs disagree on the card "
             f"({model})")


def run_parity(adaptive, iters=2, model="f2", **driver_attrs):
    """24 x 32 cohort, float64, ``iters`` iterations on cuda and on the
    CPU, with ``driver_attrs`` set on both Drivers; ``model`` a family of
    the CLI's --model (family_ped's cohort; for ng2 the F1 parents carry
    their simulated genotypes, so that their leaves, the updates and the
    flips have information to work on)."""
    from cnf2freq_tpu_torch import Driver, copy_pedigree
    base = family_ped(model, n_f2=24, n_markers=32, n_founder_pairs=2,
                      seed=11, typed_parents=model == "ng2")
    peds = {dev: copy_pedigree(base) for dev in ("cuda", "cpu")}
    drivers = {dev: Driver(p, dtype=torch.float64, device=dev,
                           adaptive_relhaplo=adaptive)
               for dev, p in peds.items()}
    infos = {}
    for dev, d in drivers.items():
        for k, v in driver_attrs.items():
            setattr(d, k, v)
        d.preprocess()
        infos[dev] = [d.iterate(early=(i == 0)) for i in range(iters)]

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
    same_steps = [(i["hitnnn"], i["inverted"]) for i in infos["cuda"]] == \
        [(i["hitnnn"], i["inverted"]) for i in infos["cpu"]]
    moved = int((rh["cpu"] != 0.5).sum())
    ok = hw_err <= 1e-9 and rh_err <= 1e-9 and pair_err <= 1e-9 and \
        md_same and same_steps
    say("parity", model=model, adaptive_relhaplo=adaptive,
        resident=drivers["cuda"]._use_resident(),
        marker_block=drivers["cuda"].marker_block,
        flip_mode=drivers["cuda"].flip_mode,
        parent_swap=drivers["cuda"].parent_swap, iterations=iters,
        inverted=[i["inverted"] for i in infos["cpu"]],
        haploweight_max_abs=f"{hw_err:.3e}", relhaplo_max_abs=f"{rh_err:.3e}",
        relhaplo_moved=moved, pair_max_abs=f"{pair_err:.3e}",
        markerdata_equal=md_same, same_hitnnn_inverted=same_steps, tol=1e-9,
        ok=ok)
    if not ok:
        fail(f"cuda and CPU float64 runs disagree (adaptive={adaptive}, "
             f"{driver_attrs})")
    # a marker-blocked family chromosome computes no coherence (relhaplo
    # keeps its values, as in the JAX Driver)
    blocked_family = model != "f2" and driver_attrs.get("marker_block")
    if adaptive and base.config.relskews and not moved and \
            not blocked_family:
        fail("parity: adaptive relhaplo left relhaplo at its loaded value")


def parity_batch(dtype):
    """The slice's cohort gathered as parity mode gathers it (the fixtrees
    mask, the gen<2 shift truncation, PARITY_VARIANTS variants), on the
    card: (fb, dists, cfg, params)."""
    from cnf2freq_tpu_torch.config import ModelConfig, RuntimeParams
    from cnf2freq_tpu_torch.hmm.family import gather_family
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    ped = simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20, seed=7)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1,
                       mask_mode="reference", parity=True,
                       n_variants=PARITY_VARIANTS)
    dists = torch.as_tensor(np.diff(ped.markerposes), dtype=dtype,
                            device="cuda")
    return fb.to("cuda", dtype), dists, ModelConfig(), RuntimeParams()


def run_scan_parity():
    """engine.chromosome_scan with probe rules at 1000 x 192 in float32, on
    the v2 pipeline and on the classic one; returns their launches."""
    from cnf2freq_tpu_torch.engine import chromosome_scan
    fb, dists, cfg, params = parity_batch(torch.float32)
    w = wrappers()
    plain = chromosome_scan(fb, dists, cfg, params)
    out = {}
    for pipeline, coh in (("v2", False), ("classic", True)):
        for fn in w.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = chromosome_scan(fb, dists, cfg, params, with_coherence=coh,
                              probe_rules=True, n_variants=PARITY_VARIANTS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: w[k].launches for k in ("stats_rules",
                                                "stats_bmns_rules",
                                                "stats", "stats_bmns")}
        stats = (res.haplo_b12, res.inf_accum, res.pair)
        finite = all(bool(torch.isfinite(x).all()) for x in
                     stats + (res.total, res.turn_weight))
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(stats, (plain.haplo_b12, plain.inf_accum,
                                plain.pair)))
        say("scan_parity", pipeline=pipeline, seconds=f"{sec:.3f}",
            launches=json.dumps(launches), n_variants=PARITY_VARIANTS,
            finite=finite, max_abs_change_from_no_rules=f"{moved:.3e}",
            peak_memory_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        name = "stats_rules" if pipeline == "v2" else "stats_bmns_rules"
        if launches[name] != PARITY_VARIANTS or \
                launches["stats"] + launches["stats_bmns"] != 0:
            fail(f"scan_parity {pipeline}: launches {launches}")
        if not finite or moved == 0:
            fail(f"scan_parity {pipeline}: non-finite statistics or the "
                 f"probe rules changed nothing")
        out[name] = launches[name]
        del res
    return out


@contextlib.contextmanager
def recording_flips(winners):
    """Append each winner of the Driver's reference flip stage to
    ``winners`` (its sorted (individual, marker) flips, or None)."""
    from cnf2freq_tpu_torch import driver as dm
    real = dm.reference_flips

    def recording(*a):
        win = real(*a)
        winners.append(None if win is None else sorted(win.flips))
        return win
    dm.reference_flips = recording
    try:
        yield winners
    finally:
        dm.reference_flips = real


def run_slice_parity():
    """Driver(parity=True) in float64 on the card at PARITY_UNITS x 192:
    preprocess() and run(3); returns the launches of its kernels."""
    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.profile_slice import stage_timers
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    ped = simulate_f2(n_f2=PARITY_UNITS, n_markers=192, n_founder_pairs=20,
                      seed=7)
    drv = Driver(ped, dtype=torch.float64, device="cuda", parity=True)
    w = wrappers()
    names = ("emission", "fb_sweep", "stats_rules", "turn", "stats")
    for fn in w.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages = ("scan_merged", "gather_family", "reference_flips",
              "_process_infprobs", "_update_haploweights")
    winners = []
    with stage_timers() as acc, recording_flips(winners):
        for name, fn in (("preprocess", drv.preprocess),
                         ("run_3", lambda: drv.run(3))):
            acc.clear()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            say("slice_parity", stage=name, seconds=f"{sec:.3f}",
                **{f"{k}_s": f"{acc[k]:.3f}" for k in stages if k in acc})
    launches = {k: w[k].launches for k in names}
    hw = np.stack([ind.haploweight for ind in ped.inds[1:]])
    tabs = np.stack(list(drv.pair_tables.values()))
    finite = bool(np.isfinite(hw).all() and np.isfinite(tabs).all()
                  and all(math.isfinite(i["loglik"]) for i in out[1:]))
    say("slice_parity", units=PARITY_UNITS, n_variants=drv._n_variants(),
        resident=drv._use_resident(), iterations=[
            None if i is None else dict(hitnnn=i["hitnnn"],
                                        inverted=i["inverted"],
                                        loglik=f"{i['loglik']:.6f}")
            for i in out], flip_winners=json.dumps(winners),
        launches=json.dumps(launches),
        finite=finite,
        peak_memory_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    if out[0] is not None or len(out) != 3:
        fail("slice_parity: run(3) did not skip iteration 0")
    if launches["stats"] != 0 or min(launches[k] for k in names
                                     if k != "stats") <= 0:
        fail(f"slice_parity: launches {launches}")
    if launches["stats_rules"] != PARITY_VARIANTS * launches["fb_sweep"]:
        fail(f"slice_parity: not {PARITY_VARIANTS} stats_rules launches a "
             f"scan: {launches}")
    if not finite:
        fail("slice_parity: non-finite outputs")
    return launches


def run_parity_mode(typed_parents=False, **driver_attrs):
    """Driver(parity=True), 24 x 32, float64, run(3) on cuda and on the
    CPU, with ``driver_attrs`` set on both: the same flip winners and the
    same state at PARITY_RTOL / PARITY_ATOL.  ``typed_parents`` marks the
    untyped F1 parents non-empty: an empty parent's turn bit is pinned and
    enters the flip stage's clauses only as a positive literal, which the
    solver satisfies for every clause of its families, so without this no
    flip wins on a simulated cohort (and with it one must)."""
    from cnf2freq_tpu_torch import Driver, copy_pedigree
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    base = simulate_f2(n_f2=24, n_markers=32, n_founder_pairs=2, seed=11)
    if typed_parents:
        for ind in base.inds[1:]:
            ind.empty = False
    peds = {dev: copy_pedigree(base) for dev in ("cuda", "cpu")}
    winners = {dev: [] for dev in peds}
    tabs = {}
    for dev, p in peds.items():
        d = Driver(p, dtype=torch.float64, device=dev, parity=True)
        for k, v in driver_attrs.items():
            setattr(d, k, v)
        with recording_flips(winners[dev]):
            d.preprocess()
            d.run(3)
        tabs[dev] = d.pair_tables

    def within(a, b):
        """(max abs difference, all within PARITY_RTOL / PARITY_ATOL)."""
        return (float(np.abs(a - b).max()),
                bool(np.allclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL)))
    errs = {f: within(*(np.stack([getattr(i, f) for i in peds[dev].inds[1:]])
                        for dev in ("cuda", "cpu")))
            for f in ("haploweight", "markersure")}
    errs["pair"] = within(np.stack([tabs["cuda"][n] for n in tabs["cpu"]]),
                          np.stack(list(tabs["cpu"].values())))
    same_win = winners["cuda"] == winners["cpu"]
    ok = same_win and all(e[1] for e in errs.values())
    say("parity_mode", typed_parents=typed_parents,
        marker_block=driver_attrs.get("marker_block"),
        flip_stages=len(winners["cpu"]),
        winners_cuda=json.dumps(winners["cuda"]), same_winners=same_win,
        **{f"{k}_max_abs": f"{e[0]:.3e}" for k, e in errs.items()},
        rtol=PARITY_RTOL, atol=PARITY_ATOL, ok=ok)
    if not ok or len(winners["cpu"]) != 2:
        fail(f"parity mode: cuda and CPU float64 runs disagree "
             f"({driver_attrs})")
    if typed_parents and not any(winners["cpu"]):
        fail("parity mode: no flip won with typed parents")


def family_row_tol(n_markers, loglik_per_unit):
    """How far a float32 pair-table row of the nohaplo slice may sum from
    1: the row is the state posterior, exp(fw_pre_f + bw_f - total) times
    renormalised sweep rows, and the two log-normalisers are recursive
    sums of n_markers float32 terms whose magnitudes add up to about the
    unit's |log-likelihood| L; each carries at most n_markers * u * L of
    rounding (the forward error bound of recursive summation), so the
    row is off by at most 2 * n_markers * u * L to first order, plus the
    share products' few ulps (1e-5).  On an NVIDIA H100 the slice's rows
    were off by 1.28e-3 against 0.029 here (L = 1256 a unit, 192
    markers)."""
    return 2 * n_markers * F32_U * abs(loglik_per_unit) + 1e-5


def run_family_slice(model, resident=None):
    """A two-generation family's slice (family_ped at 1000 x 192) in
    float32 through the Driver (its default, resident, iteration, or
    ``resident``): preprocess(), iterate(early=True), iterate() x 2, with
    each stage's seconds and synchronising calls, the peak memory, and
    the 4-state entry's launches; fails on a non-finite output, a
    haploweight outside [0, 1] (ng2), a pair-table row whose sum is
    further from 1 than family_row_tol allows (nohaplo), the 4-state
    entry never launched or any other kernel launched.  Returns its
    launches."""
    from cnf2freq_tpu_torch import Driver
    phase = f"slice_{model}"
    ped = family_ped(model)
    drv = Driver(ped, dtype=torch.float32, device="cuda")
    if resident is not None:
        drv.resident = resident
    w = wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in w.values():
        fn.launches = 0
    stages = [("preprocess", drv.preprocess),
              ("iterate_early", lambda: drv.iterate(early=True)),
              ("iterate_1", drv.iterate), ("iterate_2", drv.iterate)]
    full_syncs, sites = 0, collections.Counter()
    for name, fn in stages:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        here = collections.Counter()
        with sync_counter(here):
            out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if name in ("iterate_1", "iterate_2"):
            full_syncs += sum(here.values())
            sites.update(here)
        extra = {} if out is None else dict(
            loglik=f"{out['loglik']:.6f}", hitnnn=out["hitnnn"],
            inverted=out["inverted"])
        say(phase, resident=drv._use_resident(), stage=name,
            seconds=f"{sec:.3f}", syncs=sum(here.values()), **extra)
        if out is not None and not math.isfinite(out["loglik"]):
            fail(f"{phase}: non-finite log-likelihood after {name}")
        if out is not None:
            loglik = out["loglik"]
    small = w["fb_small"].launches
    others = other_launches(w, ("fb_small", "fb_small_nohaplo"))
    updates = {k: w[k].launches for k in UPDATE_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    hw = np.stack([ind.haploweight for ind in ped.inds[1:]])
    tabs = np.stack(list(drv.pair_tables.values()))
    finite = bool(np.isfinite(hw).all() and np.isfinite(tabs).all())
    hw_ok = bool((hw >= 0).all() and (hw <= 1).all())
    row_dev = float(np.abs(tabs.sum(axis=(-1, -2)) - 1).max())
    row_tol = family_row_tol(ped.num_markers, loglik / len(ped.dous))
    say(phase, resident=drv._use_resident(), fb_small_launches=small,
        update_launches=json.dumps(updates),
        other_kernel_launches=json.dumps(others), finite=finite,
        haploweights_in_range=hw_ok, pair_tables=len(drv.pair_tables),
        pair_row_sum_max_dev=f"{row_dev:.3e}",
        pair_row_sum_tol=f"{row_tol:.3e}",
        peak_memory_gb=f"{peak / 1e9:.3f}",
        full_iteration_syncs=full_syncs,
        per_full_iteration=f"{full_syncs / 2:.1f}",
        top_sites=json.dumps(sites.most_common(4)))
    if not (finite and hw_ok):
        fail(f"{phase}: non-finite or out-of-range outputs")
    if ped.config.deep_walk and row_dev > row_tol:
        fail(f"{phase}: a pair-table row sums {row_dev} away from 1")
    if small <= 0:
        fail(f"{phase}: the 4-state sweep entry never launched")
    if others:
        fail(f"{phase}: a 64-state kernel launched: {others}")
    check_no_capped_syncs(phase, sites)
    if ped.config.haplotyping and min(updates[k] for k in (
            "capped_haplo", "capped_infprob")) <= 0:
        fail(f"{phase}: a capped entry never launched: {updates}")
    return small


def run_ext_slice(model, resident=None, split=True):
    """An extended slice (ext_ped at 1000 x 192) in float32 through the
    Driver (its default, resident, iteration, or ``resident``):
    preprocess(), iterate(early=True), iterate() x 2, with each stage's
    seconds and synchronising calls, then (``split``) one more full
    iteration under profile_slice's stage timers (synchronised: the
    engine's stages as ``ext.*``), the peak memory and fb_ext's launches;
    fails on a
    non-finite output, a haploweight outside [0, 1], a relhaplo outside
    [1e-4, 1 - 1e-4] or none moved, fb_ext never launched or any other
    kernel launched.  Returns fb_ext's launches in the first four
    stages."""
    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.profile_slice import stage_timers
    phase = f"slice_{model}"
    ped = ext_ped(model)
    rh0 = np.stack([ind.relhaplo for ind in ped.inds[1:]]).copy()
    drv = Driver(ped, dtype=torch.float32, device="cuda")
    if resident is not None:
        drv.resident = resident
    w = wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in w.values():
        fn.launches = 0
    stages = [("preprocess", drv.preprocess),
              ("iterate_early", lambda: drv.iterate(early=True)),
              ("iterate_1", drv.iterate), ("iterate_2", drv.iterate)]
    full_syncs, sites = 0, collections.Counter()
    for name, fn in stages:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        here = collections.Counter()
        with sync_counter(here):
            out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if name in ("iterate_1", "iterate_2"):
            full_syncs += sum(here.values())
            sites.update(here)
        extra = {} if out is None else dict(
            loglik=f"{out['loglik']:.6f}", hitnnn=out["hitnnn"],
            inverted=out["inverted"])
        say(phase, resident=drv._use_resident(), stage=name,
            seconds=f"{sec:.3f}", syncs=sum(here.values()), **extra)
        if out is not None and not math.isfinite(out["loglik"]):
            fail(f"{phase}: non-finite log-likelihood after {name}")
    launches = w["fb_ext"].launches
    others = other_launches(w, ("fb_ext", "fb_ext_relskewstates"))
    updates = {k: w[k].launches for k in UPDATE_KERNELS}
    chunk = drv._chunk_size(len(ped.dous), ped.num_markers, True)
    if split:
        with stage_timers() as acc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv.iterate()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        stages = {k: round(v, 3) for k, v in sorted(acc.items(),
                                                     key=lambda kv: -kv[1])}
        say(phase, resident=drv._use_resident(), stage="iterate_3_split",
            seconds=f"{total:.3f}", split="synchronised",
            stages=json.dumps(stages))
    peak = torch.cuda.max_memory_allocated()
    hw = np.stack([ind.haploweight for ind in ped.inds[1:]])
    rh = np.stack([ind.relhaplo for ind in ped.inds[1:]])
    tabs = np.stack(list(drv.pair_tables.values()))
    finite = bool(np.isfinite(hw).all() and np.isfinite(tabs).all()
                  and np.isfinite(rh).all())
    hw_ok = bool((hw >= 0).all() and (hw <= 1).all())
    moved = int((rh != rh0).sum())
    say(phase, resident=drv._use_resident(), fb_ext_launches=launches,
        update_launches=json.dumps(updates),
        other_kernel_launches=json.dumps(others), chunk_units=chunk,
        n_variants=drv._n_variants(), finite=finite,
        haploweights_in_range=hw_ok, pair_tables=len(drv.pair_tables),
        relhaplo_moved=moved, relhaplo_min=f"{rh.min():.6g}",
        relhaplo_max=f"{rh.max():.6g}",
        peak_memory_gb=f"{peak / 1e9:.3f}",
        full_iteration_syncs=full_syncs,
        per_full_iteration=f"{full_syncs / 2:.1f}",
        top_sites=json.dumps(sites.most_common(4)))
    if not (finite and hw_ok):
        fail(f"{phase}: non-finite or out-of-range outputs")
    if moved == 0:
        fail(f"{phase}: no relhaplo moved from its loaded value")
    if rh.min() < RELHAPLO_CLIP or rh.max() > 1 - RELHAPLO_CLIP:
        fail(f"{phase}: relhaplo outside [1e-4, 1 - 1e-4]")
    if launches <= 0:
        fail(f"{phase}: fb_ext never launched")
    if others:
        fail(f"{phase}: another kernel launched: {others}")
    check_no_capped_syncs(phase, sites)
    if min(updates[k] for k in ("capped_haplo", "capped_infprob")) <= 0:
        fail(f"{phase}: a capped entry never launched: {updates}")
    return launches


def run_impute_example(tmp, card):
    """The port's imputation example (examples/impute_cohort.py) at the
    slices' cohort size on the card in float32: stage seconds, score, the
    JAX example's exit code (printed, not asserted), the launches of
    fb_classic (#5) and stats_bmns (#3b), peak memory; fails if it raises,
    writes a missing or empty file, launches #5 fewer than iterations + 1
    times or #3b fewer than iterations times, or writes a dump that
    parses (utils.refparity) into another state than the pedigree's
    beyond the dump's rounding."""
    from cnf2freq_tpu_torch.examples import impute_cohort as ex
    from cnf2freq_tpu_torch.utils.refparity import (compare, parse_dump,
                                                    state_from_pedigree)
    w = wrappers()
    for fn in w.values():
        fn.launches = 0
    lo_launches, record = [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        with counting_line_origin(lo_launches), timed_stages(record):
            score, paths, drv = ex.impute_cohort(
                IMPUTE_UNITS, IMPUTE_MARKERS, IMPUTE_ITERS, 7,
                os.path.join(tmp, "impute_demo"), "cuda")
    except Exception as e:
        traceback.print_exc()
        fail(f"impute_example: the example raised {e!r}")
    peak = torch.cuda.max_memory_allocated()
    launches = {k: w[k].launches for k in ("fb_classic", "stats_bmns") +
                UPDATE_KERNELS}
    secs = {"simulate_mask": sum(sec for st, sec, _ in record
                                 if st in ("simulate", "mask"))}
    n_iter = 0
    for stage, sec, _ in record:
        if stage == "iterate":
            stage, n_iter = f"iterate_{n_iter}", n_iter + 1
        if stage not in ("simulate", "mask"):
            secs[stage] = secs.get(stage, 0.0) + sec
    for stage, sec in secs.items():
        say("impute_example", stage=stage, seconds=f"{sec:.3f}")
    say("impute_example", units=IMPUTE_UNITS, markers=IMPUTE_MARKERS,
        iterations=IMPUTE_ITERS, score=json.dumps(score),
        exit_code=ex.exit_code(score), launches=json.dumps(launches),
        line_origin_fb_classic_launches=lo_launches,
        peak_memory_gb=f"{peak / 1e9:.3f}", card=card)
    sizes = {k: os.path.getsize(p) if os.path.exists(p) else 0
             for k, p in paths.items()}
    if min(sizes.values()) <= 0:
        fail(f"impute_example: a missing or empty file: {sizes}")
    if launches["fb_classic"] < IMPUTE_ITERS + 1 or \
            launches["stats_bmns"] < IMPUTE_ITERS:
        fail(f"impute_example: launches {launches} in {IMPUTE_ITERS} "
             f"iterations and a line-origin pass")
    check_update_launches("impute_example", launches, updates=IMPUTE_ITERS,
                          chromosomes=drv.ped.num_chromosomes)
    with open(paths["dump"]) as f:
        blocks = parse_dump(f.read(), drv.ped.num_markers)
    dev = compare(blocks[-1], state_from_pedigree(drv.ped))
    ok = len(blocks) == 1 and dev["genotype_mismatches"] == 0 and all(
        dev[k] <= DUMP_ATOL for k in ("haploweight", "markersure",
                                      "relhaplo"))
    say("impute_example", dump_round_trip=json.dumps(dev),
        dump_blocks=len(blocks), file_bytes=json.dumps(sizes),
        tol=DUMP_ATOL, ok=ok)
    if not ok:
        fail("impute_example: the dump does not parse back into the "
             "pedigree's state")


def run_impute_example_parity(tmp):
    """The example at 24 x 32 in float64 with 2 iterations on cuda and on
    the CPU: the genotype and line-origin tables within CLI_ATOL, the
    dumps within CLI_ATOL but for the collapse-tie departures that
    utils.dumpcompare admits (at most MAX_DEPARTED), the same score."""
    from cnf2freq_tpu_torch.driver import Driver
    from cnf2freq_tpu_torch.examples import impute_cohort as ex
    from cnf2freq_tpu_torch.utils.dumpcompare import (compare_dumps, faults,
                                                      recording_collapse)
    runs, seen = {}, {}
    for dev in ("cuda", "cpu"):
        seen[dev] = []
        with contextlib.redirect_stderr(io.StringIO()), \
                recording_collapse(Driver, seen[dev]):
            runs[dev] = ex.impute_cohort(
                24, 32, 2, 7, os.path.join(tmp, f"impute_parity_{dev}"),
                dev, dtype=np.float64)[:2]
    (score_c, paths_c), (score_h, paths_h) = runs["cuda"], runs["cpu"]
    worst = 0.0
    for kind in ("genotypes", "lineorigin"):
        a, b = numbers(paths_c[kind]), numbers(paths_h[kind])
        if a.size != b.size or a.size == 0:
            fail(f"impute_example_parity: {kind} prints {a.size} and "
                 f"{b.size} numbers")
        worst = max(worst, float(np.abs(a - b).max()))
    # the one dump, written after the last iteration: the flags as that
    # iteration started
    dump_err, departed = compare_dumps(
        paths_c["dump"], paths_h["dump"], seen["cuda"][-1:],
        seen["cpu"][-1:], 1, CLI_ATOL)
    broken = faults(departed, MAX_DEPARTED)
    ok = worst <= CLI_ATOL and dump_err <= CLI_ATOL and not broken and \
        score_c == score_h
    say("impute_example_parity", tables_max_abs=f"{worst:.2e}",
        dump_max_abs=f"{dump_err:.2e}",
        departed_dump_blocks=json.dumps(
            [(p.block, round(p.haploweight, 6), round(p.relhaplo, 6))
             for p in departed]),
        departure_faults=json.dumps(broken), max_departed=MAX_DEPARTED,
        score_cuda=json.dumps(score_c), score_cpu=json.dumps(score_h),
        tol=CLI_ATOL, ok=ok)
    if not ok:
        fail("impute_example_parity: the example's float64 runs on cuda "
             "and the CPU disagree")


def run_cli_models(tmp, n_f2=1000):
    """The cli phase's 1000 x 192 files through the CLI on the card
    (float32) with --model ng2, with --model nohaplo --lineorigin and
    with --model relskewstates, and simulate_plantimpute_selfed_files(
    n_lines=1000, n_markers=192, generations=4, spacing_cm=1.0, seed=3)
    with --model selfing, and once more with --markerblock 64, --count 2
    each (the script's time limit; the other CLI phases run 3):
    every F2 (or line) block written, finite, table rows summing to 1
    within CLI_ATOL, the family's sweep entries launched (fb_small for
    the two-generation families, fb_ext for the extended ones, the
    blocked entries fb_ext_init and fb_ext_carry with --markerblock) and
    no other kernel."""
    from cnf2freq_tpu_torch import cli
    from cnf2freq_tpu_torch.utils.simulate import \
        simulate_plantimpute_selfed_files
    d = os.path.join(tmp, "cli")
    selfed = simulate_plantimpute_selfed_files(
        os.path.join(tmp, "cli_selfed"), n_lines=n_f2, n_markers=192,
        generations=4, spacing_cm=1.0, seed=3)[:3]
    runs = [("ng2", [], ("fb_small",)), ("nohaplo", [], ("fb_small",)),
            ("selfing", [], ("fb_ext",)), ("relskewstates", [], ("fb_ext",)),
            ("selfing", ["--markerblock", "64"],
             ("fb_ext_init", "fb_ext_carry"))]
    for model, extra, kernels in runs:
        tag = model + ("_blocked" if extra else "")
        files = selfed if model == "selfing" else [
            os.path.join(d, f"synth.{x}") for x in ("map", "ped", "gen")]
        io_args = ["--mapfile", files[0], "--pedfile", files[1],
                   "--genfile", files[2], "--count", "2"]
        out = os.path.join(d, f"{tag}.out")
        argv = io_args + ["--model", model, "--output", out, "--dump",
                          os.path.join(d, f"{tag}.dump")] + extra
        tables = [(out, 4)]
        if model == "nohaplo":
            argv += ["--lineorigin", os.path.join(d, f"{tag}.lo")]
            tables.append((os.path.join(d, f"{tag}.lo"), 3))
        w = wrappers()
        for fn in w.values():
            fn.launches = 0
        record, err = [], io.StringIO()
        with timed_stages(record), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        mine = {k: w[k].launches for k in kernels}
        ours = [w[k] for k in kernels]
        others = {k: fn.launches for k, fn in w.items()
                  if all(fn is not o for o in ours) and fn.launches
                  and k not in UPDATE_KERNELS}
        updates = {k: w[k].launches for k in UPDATE_KERNELS}
        secs = collections.defaultdict(float)
        for stage, sec, _ in record:
            secs[stage] += sec
        say("cli_models", model=model, extra=" ".join(extra) or None, rc=rc,
            launches=json.dumps(mine), update_launches=json.dumps(updates),
            other_kernel_launches=json.dumps(others),
            seconds=json.dumps({k: round(v, 3) for k, v in secs.items()}))
        if rc != 0:
            fail(f"cli_models {tag}: returned {rc}")
        if min(mine.values()) <= 0 or others:
            fail(f"cli_models {tag}: launches {mine}, others {others}")
        for path, width in tables:
            vals = numbers(path)
            blocks = table_blocks(path, width)
            unit = "L_" if model == "selfing" else "F2_"
            f2 = [b for b in blocks if b.startswith(unit)]
            rows = np.concatenate(list(blocks.values()))
            dev = float(np.abs(rows.sum(axis=1) - 1).max())
            say("cli_models", model=model, output=os.path.basename(path),
                unit_blocks=len(f2), rows=len(rows),
                finite=bool(np.isfinite(vals).all()),
                max_row_sum_dev=f"{dev:.2e}")
            if len(f2) != n_f2 or not np.isfinite(vals).all() or \
                    dev > CLI_ATOL:
                fail(f"cli_models {tag}: {path}: {len(f2)} unit blocks, "
                     f"a non-finite value or a row sum off by {dev}")
        if not np.isfinite(numbers(os.path.join(d, f"{tag}.dump"))).all():
            fail(f"cli_models {tag}: non-finite values in the dump")


class Tee(io.TextIOBase):
    """Write to several streams (the CLI's stderr lines are both shown and
    checked)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)


@contextlib.contextmanager
def timed_stages(record):
    """Time the CLI's stages: each wrapped call appends (stage, seconds,
    positional arguments), synchronised with the card on either side."""
    import cnf2freq_tpu_torch.io as pio
    import cnf2freq_tpu_torch.io.haps as phaps
    import cnf2freq_tpu_torch.io.outputs as pout
    import cnf2freq_tpu_torch.io.plink as pplink
    import cnf2freq_tpu_torch.io.vcf as pvcf
    import cnf2freq_tpu_torch.utils.harness as pharness
    import cnf2freq_tpu_torch.utils.simulate as psim
    from cnf2freq_tpu_torch import Driver
    targets = [(pio, "load_plantimpute", "load"),
               (psim, "simulate_f2", "simulate"),
               (pharness, "mask_markers", "mask"),
               (phaps, "read_sample", "read_sample"),
               (phaps, "read_haps_full", "read_haps"),
               (pplink, "read_fam_bed", "read_fam_bed"),
               (pvcf, "output_vcf", "write_vcf"),
               (phaps, "create_hap_file", "create_hap_file"),
               (Driver, "preprocess", "preprocess"),
               (Driver, "iterate", "iterate"),
               (Driver, "line_origin_tables", "line_origin"),
               (pout, "write_genotype_table", "write_table"),
               (pout, "write_line_origin_table", "write_line_origin"),
               (pout, "write_haplotype_dump", "write_dump"),
               (pout, "deserialize", "read_checkpoint")]
    saved = []
    for obj, attr, stage in targets:
        fn = getattr(obj, attr)
        saved.append((obj, attr, fn))

        def wrapped(*a, _fn=fn, _stage=stage, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            record.append((_stage, time.perf_counter() - t0, a))
            return out
        setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def numbers(path):
    """Every number a text output prints, in order."""
    out = []
    with open(path) as f:
        for line in f:
            for tok in line.replace(":", " ").split():
                try:
                    out.append(float(tok))
                except ValueError:
                    pass
    return np.array(out)


def table_blocks(path, width):
    """{name: [rows, width]} of a genotype or line-origin table."""
    blocks, name, rows = {}, None, []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 1 and parts[0].endswith(":1"):
                if name is not None:
                    blocks[name] = np.array(rows)
                name, rows = parts[0][:-2], []
            elif len(parts) == width:
                rows.append([float(x) for x in parts])
    if name is not None:
        blocks[name] = np.array(rows)
    return blocks


@contextlib.contextmanager
def counting_line_origin(lo_launches):
    """Within the block, each Driver.line_origin_tables call appends the
    fb_classic launches it made to ``lo_launches``."""
    from cnf2freq_tpu_torch import Driver
    real = Driver.line_origin_tables

    def counted(self):
        before = wrappers()["fb_classic"].launches
        out = real(self)
        lo_launches.append(wrappers()["fb_classic"].launches - before)
        return out

    Driver.line_origin_tables = counted
    try:
        yield lo_launches
    finally:
        Driver.line_origin_tables = real


def run_cli_once(argv):
    """cli.main(argv) with its stage seconds, launches and stderr."""
    from cnf2freq_tpu_torch import cli
    w = wrappers()
    for fn in w.values():
        fn.launches = 0
    record, err = [], io.StringIO()
    with timed_stages(record), contextlib.redirect_stderr(Tee(sys.stderr,
                                                              err)):
        rc = cli.main(argv)
    launches = {k: w[k].launches for k in ("fb_classic", "stats_bmns")}
    return rc, record, launches, err.getvalue()


def run_cli(tmp, card, n_f2=1000, n_markers=192):
    """The PlantImpute workflow at 1000 x 192 through the port's CLI on
    the card (float32, the CLI's default there)."""
    from cnf2freq_tpu_torch.io import deserialize, load_plantimpute
    from cnf2freq_tpu_torch.utils.simulate import simulate_plantimpute_files
    d = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    files = simulate_plantimpute_files(d, n_f2=n_f2, n_markers=n_markers,
                                       spacing_cm=1.0, missing_rate=0.3,
                                       error_rate=0.02, seed=11)
    mapfile, pedfile, genfile, truths = files
    say("cli", stage="write_files", seconds=f"{time.perf_counter() - t0:.3f}")
    ck = os.path.join(d, "ck")
    io_args = ["--mapfile", mapfile, "--pedfile", pedfile,
               "--genfile", genfile, "--checkpoint", ck]
    first = io_args + ["--count", "3", "--output", os.path.join(d, "t3"),
                       "--dump", os.path.join(d, "d3"), "--lineorigin",
                       os.path.join(d, "lo3")]
    resume = io_args + ["--count", "4", "--output", os.path.join(d, "t4"),
                        "--dump", os.path.join(d, "d4")]

    lo_launches = []
    torch.cuda.reset_peak_memory_stats()
    with counting_line_origin(lo_launches):
        runs = [run_cli_once(first), run_cli_once(resume)]
    peak = torch.cuda.max_memory_allocated()
    drivers = []
    for tag, (rc, record, launches, err) in zip(("count3", "resume4"), runs):
        for stage, sec, a in record:
            if stage == "preprocess":
                drivers.append(a[0])
            say("cli", run=tag, stage=stage, seconds=f"{sec:.3f}")
        say("cli", run=tag, rc=rc, launches=json.dumps(launches))
        if rc != 0:
            fail(f"cli {tag}: returned {rc}")
        if min(launches.values()) <= 0:
            fail(f"cli {tag}: a kernel of the path never launched: "
                 f"{launches}")
    say("cli", line_origin_fb_classic_launches=lo_launches,
        peak_memory_gb=f"{peak / 1e9:.3f}", card=card)
    if not lo_launches or lo_launches[0] <= 0:
        fail("cli: the line-origin pass launched no fb_classic")

    err = runs[1][3]
    iters = [ln.split(":")[0] for ln in err.splitlines()
             if ln.startswith("iter ")]
    if "(3 iterations done)" not in err or iters != ["iter 3"]:
        fail(f"cli: the resume did not continue at iteration 3: {iters}")

    M = n_markers
    with open(genfile) as f:
        codes = {p[0]: np.array([int(x) for x in p[1:M + 1]])
                 for p in (ln.split() for ln in f)}
    for name, width in (("t3", 4), ("lo3", 3), ("t4", 4)):
        path = os.path.join(d, name)
        vals = numbers(path)
        blocks = table_blocks(path, width)
        f2 = [b for b in blocks if b.startswith("F2_")]
        rows = np.concatenate(list(blocks.values()))
        dev = float(np.abs(rows.sum(axis=1) - 1).max())
        say("cli", output=name, blocks=len(blocks), f2_blocks=len(f2),
            rows=len(rows), finite=bool(np.isfinite(vals).all()),
            max_row_sum_dev=f"{dev:.2e}")
        if len(f2) != n_f2:
            fail(f"cli {name}: {len(f2)} F2 blocks, expected {n_f2}")
        if not np.isfinite(vals).all() or dev > CLI_ATOL:
            fail(f"cli {name}: non-finite values or a row sum off by {dev}")
        if width == 4:
            hit = {True: [0, 0], False: [0, 0]}
            for b in f2:
                call = blocks[b][:M, :3].argmax(axis=1)
                truth = (truths[b] == 2).sum(axis=1)
                masked = codes[b] == 9
                for m in (True, False):
                    sel = masked == m
                    hit[m][0] += int((call[sel] == truth[sel]).sum())
                    hit[m][1] += int(sel.sum())
            acc_m = hit[True][0] / hit[True][1]
            acc_o = hit[False][0] / hit[False][1]
            say("cli", output=name, masked_accuracy=f"{acc_m:.4f}",
                masked_entries=hit[True][1], observed_accuracy=f"{acc_o:.4f}",
                observed_entries=hit[False][1])
            if acc_m < MIN_MASKED_ACCURACY:
                fail(f"cli {name}: masked-entry accuracy {acc_m:.4f} below "
                     f"{MIN_MASKED_ACCURACY}")
    for name in ("d3", "d4", "ck"):
        if not np.isfinite(numbers(os.path.join(d, name))).all():
            fail(f"cli {name}: non-finite values in the dump")

    # the final dump reads back into a fresh pedigree
    fresh = load_plantimpute(mapfile, pedfile, genfile)
    with open(os.path.join(d, "d4")) as f:
        switches = deserialize(fresh, f)
    final = drivers[-1].ped
    hw_err = max(float(np.abs(a.haploweight - b.haploweight).max())
                 for a, b in zip(fresh.inds[1:], final.inds[1:]))
    md_same = all(np.array_equal(a.markerdata, b.markerdata)
                  for a, b in zip(fresh.inds[1:], final.inds[1:]))
    say("cli", deserialized=len(switches), haploweight_max_abs=f"{hw_err:.2e}",
        markerdata_equal=md_same)
    if len(switches) != len(final.inds) - 1 or hw_err > 1e-6 or not md_same:
        fail("cli: the final dump does not read back into a fresh pedigree")


def run_cli_formats(tmp, card, n_f2=1000, n_markers=192):
    """The ShapeIT haps + PLINK fam/bed + VCF input set of the slice's
    cohort through the port's CLI on the card (float32), then one
    --createhapfile run."""
    from cnf2freq_tpu_torch import driver as dm
    from cnf2freq_tpu_torch.utils.simulate import (argv_of, simulate_f2,
                                                   write_cohort_files)
    d = os.path.join(tmp, "cli_formats")
    t0 = time.perf_counter()
    ped = simulate_f2(n_f2=n_f2, n_markers=n_markers, n_founder_pairs=20,
                      seed=7)
    flags = write_cohort_files(ped, d, "haps", seed=7)
    say("cli_formats", stage="write_files",
        seconds=f"{time.perf_counter() - t0:.3f}")
    trace, vcf = os.path.join(d, "trace.jsonl"), os.path.join(d, "out.vcf")
    argv = argv_of(flags) + ["--count", "3", "--dump", os.path.join(d, "dump"),
                             "--trace", trace, "--outputvcffile", vcf]
    scans = []
    real_scan = dm.sharded_scan_merged

    def counted_scan(fb, *a, **kw):
        scans.append(fb.md.shape[0])
        return real_scan(fb, *a, **kw)
    torch.cuda.reset_peak_memory_stats()
    dm.sharded_scan_merged = counted_scan
    try:
        rc, record, launches, err = run_cli_once(argv)
    finally:
        dm.sharded_scan_merged = real_scan
    peak = torch.cuda.max_memory_allocated()
    for stage, sec, _ in record:
        say("cli_formats", stage=stage, seconds=f"{sec:.3f}")
    if rc != 0:
        fail(f"cli_formats: returned {rc}")
    with open(trace) as f:
        text = f.read()
    recs = [json.loads(line) for line in text.splitlines()]
    its = [r for r in recs if r.get("event") == "iteration"]
    totals = collections.Counter()
    for r in recs:
        if r["type"] == "span":
            totals[r["name"]] += r["seconds"]
    n_units = len(ped.inds) - 1
    chunks = len(scans) / 3
    say("cli_formats", rc=rc, units=n_units, launches=json.dumps(launches),
        chunks_per_iteration=chunks, chunk_units=json.dumps(sorted(
            set(scans))), peak_memory_gb=f"{peak / 1e9:.3f}", card=card,
        iteration_records=len(its),
        inverted=[r["inverted"] for r in its],
        hitnnn=[r["hitnnn"] for r in its])
    say("cli_formats", longest_spans=json.dumps(
        [(k, round(v, 3)) for k, v in totals.most_common(10)]))
    for split in trace_split(text):
        say("cli_formats", tracer="host clock, unsynchronised", **split)
    if len(its) != 3:
        fail(f"cli_formats: {len(its)} iteration records, expected 3")
    if min(launches.values()) <= 0 or \
            launches["fb_classic"] != len(scans) or \
            launches["stats_bmns"] != len(scans):
        fail(f"cli_formats: launches {launches} against {len(scans)} "
             f"chunk scans")
    if not np.isfinite(numbers(os.path.join(d, "dump"))).all():
        fail("cli_formats: non-finite values in the dump")
    with open(vcf) as f:
        gts = [c.split(":")[0] for ln in f if not ln.startswith("#")
               for c in ln.rstrip("\n").split("\t")[9:]]
    valid = sum(g in ("0|0", "0|1", "1|0", "1|1") for g in gts)
    say("cli_formats", rewritten_gt_fields=len(gts), valid=valid,
        expected=n_units * n_markers)
    if len(gts) != n_units * n_markers or valid != len(gts):
        fail("cli_formats: the VCF rewrite is incomplete")

    created = os.path.join(d, "created.haps")
    rc, record, _, err = run_cli_once(argv_of(flags) +
                                      ["--createhapfile", created])
    for stage, sec, _ in record:
        say("cli_formats", run="createhapfile", stage=stage,
            seconds=f"{sec:.3f}")
    with open(created) as f:
        lines = sum(1 for _ in f)
    say("cli_formats", run="createhapfile", rc=rc, lines=lines,
        iterations=sum(ln.startswith("iter ") for ln in err.splitlines()))
    if rc != 0 or lines != n_markers or "iter " in err:
        fail("cli_formats: --createhapfile did not write the haps file "
             "alone")


def host_copy(x):
    """A CPU copy of a resident_updates argument: a tensor, the
    accumulators or the cohort's static tensors; anything else as is."""
    from cnf2freq_tpu_torch.resident import CohortStatic, ResidentAccum
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, ResidentAccum):
        y = object.__new__(ResidentAccum)
        y.__dict__ = {k: host_copy(v) for k, v in vars(x).items()}
        return y
    if isinstance(x, CohortStatic):
        return dataclasses.replace(x, **{
            f.name: host_copy(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


@contextlib.contextmanager
def recording_updates(log):
    """Within the block, each resident update appends (its arguments and
    its outputs, copied to the CPU) to ``log``."""
    from cnf2freq_tpu_torch import driver as dm
    real = dm.resident_updates

    def updates(*args, **kw):
        out = real(*args, **kw)
        log.append(([host_copy(a) for a in args],
                    out._replace(**{k: v.cpu()
                                    for k, v in out._asdict().items()})))
        return out
    dm.resident_updates = updates
    try:
        yield log
    finally:
        dm.resident_updates = real


def updates_on_host(log):
    """Each card update of ``log`` re-run on the CPU from the card's own
    inputs: ([(the card's hits, the CPU's)], the largest difference of
    markersure, haploweight and relhaplo, markerdata equal throughout)."""
    from cnf2freq_tpu_torch.resident import resident_updates
    hits, worst, same_md = [], 0.0, True
    for args, card in log:
        host = resident_updates(*args)
        hits.append((int(card.hits), int(host.hits)))
        same_md &= bool(torch.equal(card.markerdata, host.markerdata))
        for k in ("markersure", "haploweight", "relhaplo"):
            worst = max(worst, float((getattr(card, k).double() -
                                      getattr(host, k).double()).abs().max()))
    return hits, worst, same_md


def iteration_records(path):
    """The trace's iteration records without their clock."""
    with open(path) as f:
        return [{k: v for k, v in r.items() if k != "t"}
                for r in map(json.loads, f) if r.get("event") == "iteration"]


def run_cli_formats_parity(tmp):
    """Each other input set of a 24 x 32 cohort through the CLI in float64
    (--count 3 --output --dump --lineorigin --trace, the haps set also
    --outputvcffile, then --createhapfile), twice on the card and once on
    the CPU.

    * The card reproduces itself: the second run writes the same bytes
      and the same iteration records, hitnnn included (the scatter sums
      add in index order, updates.scatter.ordered_sums).
    * Card against CPU: every number of the tables within CLI_ATOL, the
      same VCF and haps text, the same inverted flags, flips and
      scalefactors, and the dumps within CLI_ATOL but for the collapse-tie
      departures that utils.dumpcompare admits, at most MAX_DEPARTED a
      set.
    * hitnnn: each iteration's count of saturated update steps on the
      card equals, exactly, the count of the update re-run on the CPU
      from the card's own accumulators and mirrors (markerdata equal, the
      other outputs within CLI_ATOL).  The card's and the CPU's runs may
      count differently: the scan kernels add in another order than
      their plain versions, the accumulators then differ in their last
      bits, and a step that starts within its epsilon of 0 or 1 decides
      its cap on those bits.  Both counts are printed."""
    from cnf2freq_tpu_torch import cli
    from cnf2freq_tpu_torch.driver import Driver
    from cnf2freq_tpu_torch.utils.dumpcompare import (compare_dumps,
                                                      dump_blocks, faults,
                                                      recording_collapse)
    from cnf2freq_tpu_torch.utils.simulate import (COHORT_FORMATS, argv_of,
                                                   simulate_f2,
                                                   write_cohort_files)
    ped = simulate_f2(n_f2=24, n_markers=32, n_founder_pairs=2, seed=11)
    for fmt in COHORT_FORMATS:
        d = os.path.join(tmp, "cli_formats_parity", fmt)
        flags = write_cohort_files(ped, d, fmt, seed=11)
        seen, log = collections.defaultdict(list), []
        outs = ["output", "dump", "lineorigin"] + \
            (["vcf", "created"] if fmt == "haps" else [])
        for tag in ("cuda", "cuda_again", "cpu"):
            dev = tag.split("_")[0]
            argv = argv_of(flags) + ["--count", "3", "--device", dev,
                                     "--x64"]
            for ext in ("output", "dump", "lineorigin", "trace"):
                argv += [f"--{ext}", os.path.join(d, f"{tag}.{ext}")]
            if fmt == "haps":
                argv += ["--outputvcffile", os.path.join(d, f"{tag}.vcf")]
            runs = [argv]
            if fmt == "haps":
                runs.append(argv_of(flags) + [
                    "--device", dev, "--createhapfile",
                    os.path.join(d, f"{tag}.created")])
            for a in runs:
                with contextlib.ExitStack() as stack:
                    stack.enter_context(
                        contextlib.redirect_stderr(io.StringIO()))
                    stack.enter_context(recording_collapse(Driver,
                                                           seen[tag]))
                    if tag == "cuda":
                        stack.enter_context(recording_updates(log))
                    rc = cli.main(a)
                if rc != 0:
                    fail(f"cli_formats_parity {fmt}: {tag} returned {rc}")

        def read(tag, ext):
            with open(os.path.join(d, f"{tag}.{ext}"), "rb") as f:
                return f.read()
        its = {tag: iteration_records(os.path.join(d, f"{tag}.trace"))
               for tag in ("cuda", "cuda_again", "cpu")}
        reproduced = its["cuda"] == its["cuda_again"] and all(
            read("cuda", ext) == read("cuda_again", ext) for ext in outs)
        worst = 0.0
        for ext in ("output", "lineorigin"):
            a, b = (numbers(os.path.join(d, f"{tag}.{ext}"))
                    for tag in ("cuda", "cpu"))
            if a.size != b.size or a.size == 0:
                fail(f"cli_formats_parity {fmt}: {ext} prints {a.size} and "
                     f"{b.size} numbers")
            worst = max(worst, float(np.abs(a - b).max()))
        same_text = all(read("cuda", ext) == read("cpu", ext)
                        for ext in ("vcf", "created") if ext in outs)
        dump_err, departed = compare_dumps(
            os.path.join(d, "cuda.dump"), os.path.join(d, "cpu.dump"),
            seen["cuda"], seen["cpu"], 3, CLI_ATOL)
        broken = faults(departed, MAX_DEPARTED)
        same_its = len(its["cuda"]) == len(its["cpu"]) == 3 and all(
            (a["inverted"], a["flips"]) == (b["inverted"], b["flips"]) and
            math.isclose(a["scalefactor"], b["scalefactor"], rel_tol=1e-12)
            for a, b in zip(its["cuda"], its["cpu"]))
        hits, update_err, same_md = updates_on_host(log)
        hits_ok = len(hits) == 3 and \
            [c for c, _ in hits] == [r["hitnnn"] for r in its["cuda"]] and \
            all(c == h for c, h in hits) and same_md and \
            update_err <= CLI_ATOL
        ok = (reproduced and worst <= CLI_ATOL and dump_err <= CLI_ATOL and
              not broken and same_its and same_text and hits_ok)
        say("cli_formats_parity", input_set=fmt,
            dump_blocks_per_iteration=len(dump_blocks(
                os.path.join(d, "cpu.dump"))) // 3,
            tables_max_abs=f"{worst:.2e}", dump_max_abs=f"{dump_err:.2e}",
            departed_dump_blocks=json.dumps(
                [(p.iteration, p.block, round(p.haploweight, 6),
                  round(p.relhaplo, 6)) for p in departed]),
            departure_faults=json.dumps(broken), max_departed=MAX_DEPARTED,
            hitnnn_cuda=[r["hitnnn"] for r in its["cuda"]],
            hitnnn_cpu_from_card_inputs=[h for _, h in hits],
            hitnnn_cpu=[r["hitnnn"] for r in its["cpu"]],
            update_max_abs=f"{update_err:.2e}", markerdata_equal=same_md,
            card_reproduced=reproduced,
            inverted_flips_scalefactor_equal=same_its,
            inverted=[r["inverted"] for r in its["cpu"]],
            texts_equal=same_text, tol=CLI_ATOL, ok=ok)
        if not ok:
            fail(f"cli_formats_parity {fmt}: the card's float64 CLI runs "
                 f"disagree with each other or with the CPU's")


def run_cli_parity(tmp):
    """24 x 32 files through the CLI in float64 on cuda and on the CPU."""
    from cnf2freq_tpu_torch import cli
    from cnf2freq_tpu_torch.utils.simulate import simulate_plantimpute_files
    d = os.path.join(tmp, "cli_parity")
    mapfile, pedfile, genfile, _ = simulate_plantimpute_files(
        d, n_f2=24, n_markers=32, seed=11)
    outs = ("out", "lo", "dump")
    for dev in ("cuda", "cpu"):
        argv = ["--mapfile", mapfile, "--pedfile", pedfile, "--genfile",
                genfile, "--count", "2", "--device", dev, "--x64"]
        for ext in outs:
            argv += ["--" + {"out": "output", "lo": "lineorigin",
                             "dump": "dump"}[ext],
                     os.path.join(d, f"{dev}.{ext}")]
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(argv)
        if rc != 0:
            fail(f"cli_parity: --device {dev} returned {rc}")
    worst = 0.0
    for ext in outs:
        a, b = (numbers(os.path.join(d, f"{dev}.{ext}"))
                for dev in ("cuda", "cpu"))
        if a.size != b.size or a.size == 0:
            fail(f"cli_parity: {ext} prints {a.size} and {b.size} numbers")
        err = float(np.abs(a - b).max())
        worst = max(worst, err)
        say("cli_parity", output=ext, numbers=a.size, max_abs=f"{err:.2e}",
            tol=CLI_ATOL, ok=err <= CLI_ATOL)
    if worst > CLI_ATOL:
        fail("cli_parity: cuda and CPU float64 CLI outputs disagree")



# -- the device mesh -------------------------------------------------------
# seconds a collective (and the rendezvous) of the mesh phases waits for a
# rank, and that a spawned rank may run, before the phase fails
MESH_COLLECTIVE_TIMEOUT_S = 120
MESH_RANK_TIMEOUT_S = 420
# mesh_world1's full iterations against the unmeshed Driver's, in turns:
# the most the meshed median may exceed the unmeshed one by, as a share of
# it, where the unmeshed samples' own spread (their interquartile range)
# is narrower; a wider spread leaves the share unresolved, and then only a
# median excess beyond that spread fails the phase
MESH_WORLD1_SLOWDOWN = 0.05
MESH_WORLD1_FULL = 4
# the order of mesh_world1's runs (True: meshed), balanced so that a drift
# of the card's speed over the phase falls on both sides alike
MESH_WORLD1_TURNS = (False, True, True, False, True, False, False, True)
MESH_RTOL, MESH_ATOL = 1e-9, 1e-11
# a checkpoint's haploweights print six decimals: half a unit of the
# sixth, and the binary rounding of the printed value
DUMP_ATOL = 5.0000001e-7


@contextlib.contextmanager
def collective_clock(acc):
    """Time every torch.distributed.all_reduce while active: the card is
    synchronised before and after each call, and acc gets the calls and
    their seconds (the synchronising changes the timeline; the phases time
    their iterations without it)."""
    import torch.distributed as dist
    real = dist.all_reduce

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        acc["seconds"] += time.perf_counter() - t0
        acc["calls"] += 1
        return out

    dist.all_reduce = timed
    try:
        yield acc
    finally:
        dist.all_reduce = real


def mesh_state(ped, drv):
    """The per-individual state and pair tables of a run, for the bitwise
    and tolerance comparisons of the mesh phases."""
    inds = ped.inds[1:]
    return dict(haploweight=np.stack([i.haploweight for i in inds]),
                markerdata=np.stack([i.markerdata for i in inds]),
                markersure=np.stack([i.markersure for i in inds]),
                relhaplo=np.stack([i.relhaplo for i in inds]),
                pair=np.stack([drv.pair_tables[n] for n in ped.dous]))


def timed_run(drv, full=2):
    """The slice's stages on ``drv`` (preprocess, the early iteration and
    ``full`` full ones), each synchronised and timed: ({stage: seconds},
    [iteration records])."""
    calls = {"preprocess": drv.preprocess,
             "iterate_early": lambda: drv.iterate(early=True)}
    calls.update({f"iterate_{i}": drv.iterate for i in range(1, full + 1)})
    secs, infos = {}, []
    for name, fn in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        if out is not None:
            infos.append(out)
    return secs, infos


def run_mesh_world1():
    """The default Driver at 1000 x 192 f32 over a one-rank NCCL mesh
    (an in-process group on a FileStore), in turns with the unmeshed
    Driver (MESH_WORLD1_TURNS; MESH_WORLD1_FULL full iterations each): the meshed state must equal the unmeshed one bit
    for bit (an all-reduce over one rank is the identity), its launches
    of fb_classic (#5) and stats_bmns (#3b) the unmeshed ones, and its
    median full iteration may exceed the unmeshed one by no more than the
    larger of MESH_WORLD1_SLOWDOWN of it and the unmeshed samples'
    interquartile spread; then one more full iteration with every
    all-reduce timed."""
    import torch.distributed as dist

    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.parallel import make_mesh
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    tmp = tempfile.mkdtemp(prefix="cnf2freq_mesh1_")
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_mesh(1)
        say("mesh_world1", backend=dist.get_backend(), mesh=mesh,
            group_seconds=f"{time.perf_counter() - t0:.3f}")
        wr = {k: wrappers()[k] for k in ("fb_classic", "stats_bmns")}
        runs = []
        for i, meshed in enumerate(MESH_WORLD1_TURNS):
            ped = simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20,
                              seed=7)
            drv = Driver(ped, dtype=torch.float32,
                         mesh=mesh if meshed else None)
            for fn in wr.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            secs, infos = timed_run(drv, full=MESH_WORLD1_FULL)
            launches = {k: fn.launches for k, fn in wr.items()}
            peak = torch.cuda.max_memory_allocated()
            runs.append(dict(meshed=meshed, secs=secs, infos=infos,
                             launches=launches, peak=peak,
                             state=mesh_state(ped, drv),
                             drv=drv if i == 2 else None))
            say("mesh_world1", meshed=meshed, resident=drv._use_resident(),
                device=drv.device,
                **{k: f"{v:.3f}" for k, v in secs.items()},
                hitnnn=[i["hitnnn"] for i in infos],
                loglik=f"{infos[-1]['loglik']:.6f}",
                launches=json.dumps(launches),
                peak_memory_gb=f"{peak / 1e9:.3f}")
        ref, got = runs[0], runs[1]
        bitwise = {k: bool(np.array_equal(got["state"][k], ref["state"][k]))
                   for k in ref["state"]}
        same_steps = [(i["hitnnn"], i["inverted"], i["loglik"])
                      for i in got["infos"]] == \
            [(i["hitnnn"], i["inverted"], i["loglik"]) for i in ref["infos"]]
        samples = {m: [r["secs"][f"iterate_{i}"] for r in runs
                       if r["meshed"] == m
                       for i in range(1, MESH_WORLD1_FULL + 1)]
                   for m in (False, True)}
        full = {m: statistics.median(v) for m, v in samples.items()}
        q1, _, q3 = statistics.quantiles(samples[False], n=4)
        spread = q3 - q1
        allowed = max(MESH_WORLD1_SLOWDOWN * full[False], spread)
        acc = {"seconds": 0.0, "calls": 0}
        drv = runs[2]["drv"]
        with collective_clock(acc):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            drv.iterate()
            torch.cuda.synchronize()
            it3 = time.perf_counter() - t1
        say("mesh_world1", full_iteration_median_unmeshed=f"{full[False]:.4f}",
            full_iteration_median_meshed=f"{full[True]:.4f}",
            ratio=f"{full[True] / full[False]:.4f}",
            unmeshed_iqr=f"{spread:.4f}",
            share_resolved=spread <= MESH_WORLD1_SLOWDOWN * full[False],
            allowed_excess=f"{allowed:.4f}",
            samples=json.dumps({str(m): [round(x, 4) for x in v]
                                for m, v in samples.items()}),
            bitwise=json.dumps(bitwise),
            same_hitnnn_inverted_loglik=same_steps,
            launches_meshed=json.dumps(got["launches"]),
            launches_unmeshed=json.dumps(ref["launches"]),
            peak_memory_gb_meshed=f"{got['peak'] / 1e9:.3f}",
            peak_memory_gb_unmeshed=f"{ref['peak'] / 1e9:.3f}")
        say("mesh_world1", stage="iterate_3 (all-reduces synchronised)",
            seconds=f"{it3:.4f}", collective_calls=acc["calls"],
            collective_seconds=f"{acc['seconds']:.4f}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(bitwise.values()) or not same_steps:
        fail(f"mesh_world1: the one-rank mesh departs from the unmeshed "
             f"Driver: {bitwise}, same steps {same_steps}")
    if got["launches"] != ref["launches"] or min(got["launches"].values()) \
            <= 0:
        fail(f"mesh_world1: launches {got['launches']} against unmeshed "
             f"{ref['launches']}")
    if full[True] - full[False] > allowed:
        fail(f"mesh_world1: full iterations {full[True]:.4f} s meshed, "
             f"{full[False]:.4f} s unmeshed (allowed excess "
             f"{allowed:.4f} s)")


def mesh_rank(rdv, rank, world, outdir, backend):
    """One rank of mesh_gloo2 or mesh_nccl (python3 chip_smoke.py
    --mesh-rank RDV RANK WORLD OUTDIR BACKEND): gloo with every rank on
    cuda:0 (NCCL refuses two ranks on one card), or NCCL with rank r on
    card r; Driver(mesh=make_mesh(world)) on the 24 x 32 float64 cohort
    of run_parity (early + 2 full iterations, then this rank's checkpoint
    shard), then the 1000 x 192 float32 slice timed (early + 2 full, and
    one more full iteration with every all-reduce timed); writes
    OUTDIR/rank<RANK>.npz."""
    import torch.distributed as dist

    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.io.sharded_checkpoint import save_sharded
    from cnf2freq_tpu_torch.parallel import make_mesh
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(
        backend, init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    out = {}
    try:
        # gloo carries the card's tensors here: the mesh is a "cuda" one
        mesh = make_mesh(world, device_type="cuda")
        ped = family_ped("f2", n_f2=24, n_markers=32, n_founder_pairs=2,
                         seed=11)
        drv = Driver(ped, dtype=torch.float64, mesh=mesh)
        _, infos = timed_run(drv)
        out.update({f"parity/{k}": v for k, v in mesh_state(ped,
                                                            drv).items()})
        out["parity/hitnnn"] = np.array([i["hitnnn"] for i in infos])
        out["parity/inverted"] = np.array([i["inverted"] for i in infos])
        save_sharded(ped, os.path.join(outdir, "ckpt"),
                     meta={"driver": drv.export_state()})
        wr = {k: wrappers()[k] for k in ("fb_classic", "stats_bmns")}
        ped = simulate_f2(n_f2=1000, n_markers=192, n_founder_pairs=20,
                          seed=7)
        drv = Driver(ped, dtype=torch.float32, mesh=mesh)
        for fn in wr.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        secs, infos = timed_run(drv)
        out["time/launches"] = np.array([wr[k].launches for k in
                                         ("fb_classic", "stats_bmns")])
        out["time/peak"] = np.array(torch.cuda.max_memory_allocated())
        acc = {"seconds": 0.0, "calls": 0}
        with collective_clock(acc):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            drv.iterate()
            torch.cuda.synchronize()
            secs["iterate_3_clocked"] = time.perf_counter() - t1
        secs["collectives_3"] = acc["seconds"]
        out["time/calls"] = np.array(acc["calls"])
        out["time/secs"] = np.array([secs[k] for k in MESH_TIMED])
        out["time/hitnnn"] = np.array([i["hitnnn"] for i in infos])
        out.update({f"slice/{k}": v for k, v in mesh_state(ped,
                                                           drv).items()})
    finally:
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()


MESH_TIMED = ("preprocess", "iterate_early", "iterate_1", "iterate_2",
              "iterate_3_clocked", "collectives_3")


def run_mesh_spawned(phase, backend, world):
    """``world`` spawned ranks (mesh_rank) over ``backend``: the 24 x 32
    float64 run held to the card's unmeshed Driver at MESH_RTOL /
    MESH_ATOL with equal hit counts, the ranks bit-identical on both
    cohorts, the 1000 x 192 float32 slice's times, and the unmeshed
    Driver resumed from the ranks' checkpoint shards."""
    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.io.sharded_checkpoint import load_sharded
    ped = family_ped("f2", n_f2=24, n_markers=32, n_founder_pairs=2,
                     seed=11)
    drv = Driver(ped, dtype=torch.float64)
    _, ref_infos = timed_run(drv)
    ref = mesh_state(ped, drv)
    tmp = tempfile.mkdtemp(prefix="cnf2freq_mesh2_")
    procs = []
    try:
        t0 = time.perf_counter()
        for r in range(world):
            log = open(os.path.join(tmp, f"log{r}.txt"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 os.path.join(tmp, "rdv"), str(r), str(world), tmp,
                 backend],
                stdout=log, stderr=subprocess.STDOUT), log))
        for p, log in procs:
            try:
                p.wait(timeout=max(1.0, MESH_RANK_TIMEOUT_S -
                                   (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                pass
        wall = time.perf_counter() - t0
        bad = []
        for r, (p, log) in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
            if p.returncode != 0:
                bad.append((r, p.returncode, open(os.path.join(
                    tmp, f"log{r}.txt")).read()[-3000:]))
        if bad:
            fail(f"{phase}: ranks failed or timed out: {bad}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(world)]
        identical = {k: all(np.array_equal(o[k], ranks[0][k])
                            for o in ranks[1:])
                     for k in ranks[0] if not k.startswith("time/")}
        got = {k[len("parity/"):]: v for k, v in ranks[0].items()
               if k.startswith("parity/")}
        errs = {k: float(np.abs(got[k] - ref[k]).max()) for k in ref}
        close = all(np.allclose(got[k], ref[k], rtol=MESH_RTOL,
                                atol=MESH_ATOL) for k in ref)
        same_steps = got["hitnnn"].tolist() == \
            [i["hitnnn"] for i in ref_infos] and \
            got["inverted"].tolist() == [i["inverted"] for i in ref_infos]
        say(phase, cohort="24x32 float64", world=world, backend=backend,
            spawn_and_run_seconds=f"{wall:.2f}",
            max_abs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()}),
            rtol=MESH_RTOL, atol=MESH_ATOL, within=close,
            same_hitnnn_inverted=same_steps,
            ranks_identical=all(identical.values()))
        for r, o in enumerate(ranks):
            secs = dict(zip(MESH_TIMED, o["time/secs"].tolist()))
            say(phase, cohort="1000x192 float32", rank=r,
                **{k: f"{v:.4f}" for k, v in secs.items()},
                collective_calls=int(o["time/calls"]),
                hitnnn=o["time/hitnnn"].tolist(),
                launches=json.dumps(dict(zip(("fb_classic", "stats_bmns"),
                                             o["time/launches"].tolist()))),
                peak_memory_gb=f"{float(o['time/peak']) / 1e9:.3f}")
        # a fresh unmeshed Driver resumes from the ranks' shards
        ckpt = os.path.join(tmp, "ckpt")
        shards = sorted(f for f in os.listdir(ckpt) if f.startswith("shard"))
        ped = family_ped("f2", n_f2=24, n_markers=32, n_founder_pairs=2,
                         seed=11)
        drv = Driver(ped, dtype=torch.float64)
        drv.preprocess()
        man = load_sharded(ped, ckpt)
        drv.import_state(man["driver"])
        md_same = bool(np.array_equal(
            np.stack([i.markerdata for i in ped.inds[1:]]),
            got["markerdata"]))
        hw_err = float(np.abs(np.stack([i.haploweight for i in ped.inds[1:]])
                              - got["haploweight"]).max())
        info = drv.iterate()
        resumed = md_same and hw_err <= DUMP_ATOL and \
            drv.state.iter == 4 and math.isfinite(info["loglik"])
        say(phase, checkpoint_shards=shards, resumed_iter=
            drv.state.iter, markerdata_equal=md_same,
            haploweight_max_abs=f"{hw_err:.2e}", dump_atol=DUMP_ATOL,
            resumed_loglik=f"{info['loglik']:.6f}", ok=resumed)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    if not (close and same_steps and all(identical.values())):
        fail(f"{phase}: the {world}-rank run departs: within={close}, "
             f"steps={same_steps}, ranks identical={identical}")
    if len(shards) != world or not resumed:
        fail(f"{phase}: checkpoint shards {shards}, resumed={resumed}")


def run_mesh_phases():
    """mesh_world1, mesh_gloo2 (two ranks on the one card) and, on a
    machine with two cards or more, mesh_nccl over min(cards, 4) ranks;
    with one card a line says that mesh_nccl was skipped."""
    run_mesh_world1()
    run_mesh_spawned("mesh_gloo2", "gloo", 2)
    n = torch.cuda.device_count()
    if n < 2:
        say("mesh_nccl", skipped="one card: NCCL runs one rank a card")
    else:
        run_mesh_spawned("mesh_nccl", "nccl", min(n, 4))


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
    # the statistics kernel's instantiations (type, layout, probe rules),
    # the capped entries', the coherence kernel's, the carry-only sweep's
    # and the relskew HMM's
    for m in re.finditer(r"Compiling entry function '(\w*(?:stats|capped_"
                         r"haplo|capped_infprob|coherence|fb_carry|relskew)"
                         r"_kernel\w*)'"
                         r"(.*?)Used (\d+) registers", text, re.S):
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       m.group(2))
        say("build", entry=m.group(1), registers=m.group(3),
            spill_stores=sp.group(1) if sp else None,
            spill_loads=sp.group(2) if sp else None)

    checks = {dt: check_kernels(dt) for dt in (torch.float64, torch.float32)}
    _ext_sweep_inputs64.cache_clear()
    update_kernel_inputs.cache_clear()
    torch.cuda.empty_cache()
    bad = [(str(dt), k) for dt, c in checks.items()
           for k, v in c.items() if not v["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    launches, _ = run_slice("slice", adaptive=False, resident=False)
    _, host_syncs = run_slice("slice_coherence", adaptive=True,
                              resident=False)
    classic, resident_syncs = run_slice("slice_resident", adaptive=True,
                                        tracer=True)
    # the kernels' launches on the main path: the default Driver
    launches.update(classic)
    say("slice_resident", full_iteration_syncs=resident_syncs,
        slice_coherence_full_iteration_syncs=host_syncs,
        fewer=resident_syncs < host_syncs, tracer=True,
        limit=RESIDENT_SYNCS)
    if not resident_syncs < host_syncs:
        fail("the resident iteration synchronises no less often than the "
             "host-gathered one")
    if resident_syncs > RESIDENT_SYNCS:
        fail(f"the resident iteration with a live Tracer made "
             f"{resident_syncs} synchronising calls in two full iterations, "
             f"more than {RESIDENT_SYNCS}")
    run_mesh_phases()
    run_slice("slice_negshift", adaptive=True, flip_mode="negshift",
              parent_swap=True)
    for resident in (False, True):
        for adaptive in (False, True):
            run_parity(adaptive, resident=resident)
    run_parity(True, iters=3, flip_mode="negshift", parent_swap=True)
    blocked = run_slice_blocked()
    launches.update({k: blocked[k] for k in ("fb_sweep_init", "fb_carry")})
    run_parity(True, marker_block=8)
    # resident=True with a block no chromosome exceeds runs resident
    run_parity(True, resident=True, marker_block=32)
    run_blocked_parity()
    tmp = tempfile.mkdtemp(prefix="cnf2freq_smoke_")
    # cli_models reads the cli phase's input files
    synth = [os.path.join(tmp, "cli", f"synth.{x}")
             for x in ("map", "ped", "gen")]
    try:
        run_cli(tmp, card)
        release(tmp, "cli", keep=synth)
        run_cli_parity(tmp)
        release(tmp, "cli_parity", keep=synth)
        run_cli_formats(tmp, card)
        release(tmp, "cli_formats", keep=synth)
        run_cli_formats_parity(tmp)
        release(tmp, "cli_formats_parity", keep=synth)
        run_cli_models(tmp)
        release(tmp, "cli_models")
        run_impute_example(tmp, card)
        release(tmp, "impute_example")
        run_impute_example_parity(tmp)
        release(tmp, "impute_example_parity")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches.update(run_scan_parity())
    launches["stats_rules"] = run_slice_parity()["stats_rules"]
    run_parity_mode()
    run_parity_mode(typed_parents=True)
    run_parity_mode(typed_parents=True, marker_block=8)
    # the two-generation families: their slices on the default (resident)
    # iteration, whose launches the summary reports, and host-gathered;
    # then cuda against the CPU
    launches["fb_small"] = run_family_slice("ng2")
    run_family_slice("ng2", resident=False)
    launches["fb_small_nohaplo"] = run_family_slice("nohaplo")
    run_family_slice("nohaplo", resident=False)
    for model in ("ng2", "nohaplo"):
        for resident in (True, False):
            run_parity(True, model=model, resident=resident)
    # the extended state spaces, the same way
    launches["fb_ext"] = run_ext_slice("selfing")
    run_ext_slice("selfing", resident=False, split=False)
    launches["fb_ext_relskewstates"] = run_ext_slice("relskewstates")
    run_ext_slice("relskewstates", resident=False, split=False)
    for model in ("selfing", "relskewstates"):
        for resident in (True, False):
            run_parity(True, model=model, resident=resident)
    # the families' marker-blocked scan: the 1000 x 1024 slices (their
    # launches in the summary), cuda against the CPU, blocked against
    # whole on the card
    blocked = run_slice_blocked_family("selfing")
    blocked.update(run_slice_blocked_family("ng2"))
    launches.update(blocked)
    for model in ("ng2", "selfing", "relskewstates"):
        run_parity(True, iters=3, model=model, marker_block=8)
        run_blocked_parity(model, n_units=200)

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
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6])
    else:
        main()
