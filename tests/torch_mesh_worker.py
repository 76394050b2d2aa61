"""One rank of the port's CPU mesh runs in tests/test_torch_mesh*.py.

    python tests/torch_mesh_worker.py RDV RANK WORLD OUTDIR CASE [CASE ...]

Joins a gloo process group of WORLD ranks through the rendezvous file RDV
(``init_distributed``), builds ``make_mesh(WORLD)``, runs each CASE in
turn on the CPU in float64 and writes every array it reads to
OUTDIR/rank<RANK>.npz.  It imports torch, numpy and the port only (no
JAX), with one torch thread.  The cohorts are built here and, for the
unmeshed and JAX runs, by the test process from the same functions.

The test process's side is at the end: ``spawn_groups`` starts the
ranks, ``results`` waits for them and ``case_arrays`` reads a case.
"""

import importlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)

# seconds a collective waits for a rank before the group raises
TIMEOUT_S = 60.0
F2 = dict(n_markers=9, seed=3, missing_rate=0.3)


def rand_merge_inputs(B=8, NI=28, M=5, seed=6):
    """Random per-unit statistics for the three merges: units of 7 slots
    drawn from NI individuals (ids 1..NI, some slots vacant, some
    members repeated), as tests/test_scatter.py draws them."""
    rng = np.random.default_rng(seed)
    slot_ind = np.zeros((B, 7), dtype=np.int32)
    for b in range(B):
        ids = rng.choice(np.arange(1, NI + 1), size=7)
        keep = rng.random(7) < 0.85
        keep[0] = True
        slot_ind[b] = np.where(keep, ids, 0)
    return dict(
        slot_ind=slot_ind, b12=rng.uniform(0, 1, (B, M, 7, 2)),
        mask=rng.random((B, M, 7)) < 0.8, hw=rng.uniform(0, 1, (B, 7, M)),
        desc=rng.integers(1, 5, B).astype(np.float64),
        accum=rng.uniform(0, 1, (B, M, 7, 2, 2)),
        values=rng.uniform(0, 1, (B, M, 7, 3)),
        lut=np.concatenate([[NI], np.arange(NI)]).astype(np.int64), NI=NI)


def ng2_cohort(K=8, package="cnf2freq_tpu_torch"):
    """The two-generation cohort of tests/test_engine_ng2.py's mesh test:
    a sire, a dam and K full sibs (8 there) typed at 12 markers, as a
    Pedigree of ``package`` (the port, or the JAX package for the test
    process's reference)."""
    config = importlib.import_module(package + ".config")
    pedigree = importlib.import_module(package + ".pedigree")
    rng = np.random.default_rng(7)
    M = 12
    ped = pedigree.Pedigree(config.ModelConfig(numgen=2))
    ped.markerposes = np.arange(M) * 2.0
    ped.chromstarts = [0, M]
    names = ["s", "dA"] + [f"k{i}" for i in range(K)]
    by = {nm: ped.getind(nm) for nm in names}
    for i in range(K):
        by[f"k{i}"].pars = (by["s"].n, by["dA"].n)
        by[f"k{i}"].gen = 2
        ped.dous.append(by[f"k{i}"].n)
    ped.freeze()
    for ind in ped.inds[1:]:
        ind.empty = False
        ind.markerdata[:] = rng.integers(1, 3, (M, 2))
        ind.markersure[:] = 0.01
        ind.haploweight[:] = 0.5
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    return ped


# the F2 cases' Driver attributes ("_bs3": chunks of 3 units, rounded up
# to a multiple of the data size under a mesh)
F2_ATTRS = {"f2": {}, "f2_host": dict(resident=False),
            "f2_bs3": dict(batch_size=3),
            "f2_host_bs3": dict(resident=False, batch_size=3),
            "parity": dict(parity=True), "blocked": dict(marker_block=4)}


def cohort(case):
    """(pedigree, Driver attributes, iterations) of a Driver case
    "NAME[:N]" (N: the number of units where the cohort takes one); the
    iterations' first is early unless the attributes say parity."""
    from cnf2freq_tpu_torch.utils.simulate import (simulate_f2,
                                                   simulate_selfed)
    name, _, n = case.partition(":")
    if name in F2_ATTRS:
        return simulate_f2(n_f2=int(n or 8), **F2), dict(F2_ATTRS[name]), 3
    if name == "ng2":
        return ng2_cohort(int(n or 8)), {}, 2
    if name == "selfed":
        return simulate_selfed(n_lines=int(n or 8), n_markers=10,
                               generations=4, seed=1), {}, 2
    if name == "remap":
        return (simulate_f2(n_f2=16, n_markers=12, n_founder_pairs=2,
                            seed=17),
                dict(remap_distances=True, adaptive_relhaplo=False), 2)
    raise ValueError(case)


def run_driver(case, mesh=None):
    """A case's Driver through preprocess() and its iterations on the
    CPU: {name: array} of its iteration records, final state, pair tables
    and exported state (and the Driver)."""
    from cnf2freq_tpu_torch import Driver
    ped, attrs, iters = cohort(case)
    ctor = {k: attrs.pop(k) for k in ("parity", "adaptive_relhaplo")
            if k in attrs}
    drv = Driver(ped, dtype=torch.float64, device="cpu", mesh=mesh, **ctor)
    for k, v in attrs.items():
        setattr(drv, k, v)
    drv.preprocess()
    infos = drv.run(iters)
    infos = [i for i in infos if i is not None]
    inds = ped.inds[1:]
    out = dict(
        hitnnn=np.array([i["hitnnn"] for i in infos]),
        inverted=np.array([i["inverted"] for i in infos]),
        scalefactor=np.array([i["scalefactor"] for i in infos]),
        loglik=np.array([i["loglik"] for i in infos]),
        haploweight=np.stack([i.haploweight for i in inds]),
        markerdata=np.stack([i.markerdata for i in inds]),
        markersure=np.stack([i.markersure for i in inds]),
        pair=np.stack([drv.pair_tables[n] for n in ped.dous]))
    if inds[0].relhaplo is not None:
        out["relhaplo"] = np.stack([i.relhaplo for i in inds])
    if ped.actrec is not None:
        out["actrec"] = np.array(ped.actrec)
    out["export"] = np.array([drv.export_state()[k] for k in
                              ("scalefactor", "oldhitnnn", "oldhitnnn2",
                               "iter")], dtype=np.float64)
    return out, drv


def run_merges(group):
    """The three merges of this rank's block of the random units, summed
    over ``group``."""
    from cnf2freq_tpu_torch.parallel.collective import (merge_haplos,
                                                        merge_infprobs,
                                                        merge_slot_stats)
    import torch.distributed as dist
    x = rand_merge_inputs()
    B = x["slot_ind"].shape[0]
    per = B // dist.get_world_size(group)
    sl = slice(dist.get_rank(group) * per, (dist.get_rank(group) + 1) * per)
    t = {k: torch.as_tensor(v[sl]) for k, v in x.items()
         if k not in ("lut", "NI")}
    lut, NI = torch.as_tensor(x["lut"]), x["NI"]
    hb, hc = merge_haplos(t["b12"], t["mask"], t["hw"], t["slot_ind"],
                          t["desc"], lut, NI, group=group)
    inf = merge_infprobs(t["accum"], t["slot_ind"], t["desc"], lut, NI,
                         group=group)
    vals = merge_slot_stats(t["values"], t["slot_ind"], NI, group=group)
    return dict(hb=hb.numpy(), hc=hc.numpy(), inf=inf.numpy(),
                slot_stats=vals.numpy())


def run_diverge(mesh):
    """The F2 Driver with rank 1's scalefactor moved after preprocess():
    whether its first iteration raised the ranks' disagreement."""
    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.utils.simulate import simulate_f2
    drv = Driver(simulate_f2(n_f2=8, **F2), dtype=torch.float64,
                 device="cpu", mesh=mesh)
    drv.preprocess()
    if mesh.get_rank() == 1:
        drv.state.scalefactor *= 1.5
    try:
        drv.iterate(early=True)
    except RuntimeError as e:
        return dict(raised=np.array("disagree" in str(e)))
    return dict(raised=np.array(False))


def main(argv):
    rdv, rank, world, outdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    cases = argv[4:]
    import torch.distributed as dist

    from cnf2freq_tpu_torch.io.sharded_checkpoint import save_sharded
    from cnf2freq_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed(coordinator=f"file://{rdv}", num_processes=world,
                     process_id=rank, timeout_s=TIMEOUT_S, backend="gloo")
    mesh = make_mesh(world)
    results = {}
    try:
        for case in cases:
            if case == "merges":
                out = run_merges(mesh.get_group("data"))
            elif case == "diverge":
                out = run_diverge(mesh)
            else:
                out, drv = run_driver(case, mesh)
                if case == "f2":
                    # one shard per rank, the manifest with the Driver's
                    # cross-iteration state
                    save_sharded(drv.ped, os.path.join(outdir, "ckpt"),
                                 meta={"driver": drv.export_state()})
            results.update({f"{case}/{k}": v for k, v in out.items()})
    finally:
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **results)
        dist.destroy_process_group()


# -- the test process's side --------------------------------------------
# seconds the test process waits for a group's ranks before it kills them
WORKER_TIMEOUT_S = 150


def spawn_groups(cases, mktemp):
    """Start one group of ranks per entry of ``cases`` ({world: [case,
    ...]}), all at once, each in a directory from ``mktemp(name)``, and
    yield {world: (directory, [(process, log path)])}; every process
    still running when the generator is closed is killed."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    out, logs = {}, []
    try:
        for world, names in cases.items():
            d = mktemp(f"mesh{world}")
            procs = []
            for r in range(world):
                log = open(d / f"log{r}.txt", "w")
                logs.append(log)
                procs.append((subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     str(d / "rdv"), str(r), str(world), str(d)] + names,
                    env=env, stdout=log, stderr=subprocess.STDOUT),
                    d / f"log{r}.txt"))
            out[world] = (d, procs)
        yield out
    finally:
        for _, procs in out.values():
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for log in logs:
            log.close()


def results(groups, world):
    """Every rank's arrays of a group, once its processes have ended
    (within WORKER_TIMEOUT_S of this wait, or all are killed and an
    AssertionError carries the log)."""
    d, procs = groups[world]
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    for p, log in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            raise AssertionError(
                f"mesh{world} ranks did not end within {WORKER_TIMEOUT_S} "
                f"s: {log.read_text()[-3000:]}")
        if p.returncode != 0:
            raise AssertionError(
                f"a rank of mesh{world} failed (exit {p.returncode}): "
                f"{log.read_text()[-3000:]}")
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


def case_arrays(ranks, case):
    """A case's arrays, after checking that every rank holds the same
    bits."""
    pre = case + "/"
    first = {k[len(pre):]: v for k, v in ranks[0].items()
             if k.startswith(pre)}
    for r, other in enumerate(ranks[1:], 1):
        for k, v in first.items():
            np.testing.assert_array_equal(other[pre + k], v,
                                          err_msg=f"rank {r} {case} {k}")
    return first


if __name__ == "__main__":
    main(sys.argv[1:])
