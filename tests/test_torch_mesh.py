"""The port's multi-GPU execution on the CPU: ``Driver(mesh=...)`` over a
gloo process group, against the port's unmeshed Driver and the JAX
package's ``Driver(mesh=make_mesh(n))``, the three merges under a group
against the JAX merges under ``shard_map``, and sharded checkpoints
across the two packages.

The ranks are spawned processes (tests/torch_mesh_worker.py: torch, numpy
and the port only, one torch thread) meeting through a rendezvous file
under the test's temporary directory, so that no TCP port can collide
between pytest workers; each is killed if it outlives
``worker.WORKER_TIMEOUT_S``.  One 2-rank and one 4-rank group run every
case, started together when the module's first test asks for them,
while this process computes the unmeshed and JAX references.
Tolerances: float64, rtol 1e-9 and atol 1e-11 (the JAX package's own
mesh tests), hit counts and inversions equal, and the ranks
bit-identical.  The ng2 and map re-estimation runs against the JAX mesh
Driver are in tests/test_torch_mesh_jax.py.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_worker as worker
from torch_mesh_worker import case_arrays, results
from torch_port_util import patch_jax_with_port_rules

from cnf2freq_tpu_torch import Driver
from cnf2freq_tpu_torch.hmm.family import gather_family
from cnf2freq_tpu_torch.io.sharded_checkpoint import (load_sharded,
                                                      save_sharded)
from cnf2freq_tpu_torch.parallel import (init_distributed, make_mesh,
                                         pad_batch, shard_batch)
from cnf2freq_tpu_torch.parallel.collective import all_sum
from cnf2freq_tpu_torch.utils.simulate import simulate_f2

RTOL, ATOL = 1e-9, 1e-11
# the cases of each group (tests/torch_mesh_worker.py: "NAME:N" is the
# cohort with N units, 8 by default; N = 9 and 10 divide by neither 2 nor
# 4 respectively; "_bs3" runs chunks of 3 units, 4 under 2 ranks: the
# 9 units make chunks of 4, 4 and 1, whose padding is a whole rank's)
CASES = {2: ["merges", "f2", "f2_host", "f2:9", "f2_bs3:9",
             "f2_host_bs3:9", "ng2", "ng2:9", "selfed", "selfed:9", "remap",
             "parity", "blocked", "diverge"],
         4: ["f2", "f2_host", "f2:10"]}
KEYS = ("haploweight", "markersure", "relhaplo", "pair", "loglik",
        "scalefactor", "actrec", "export")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The two groups, started together: {world: (output directory,
    [(process, log path)])}; every process is killed at the end of the
    module if it still runs."""
    yield from worker.spawn_groups(CASES, tmp_path_factory.mktemp)


def assert_same_run(got, ref, what):
    np.testing.assert_array_equal(got["hitnnn"], ref["hitnnn"], what)
    np.testing.assert_array_equal(got["inverted"], ref["inverted"], what)
    np.testing.assert_array_equal(got["markerdata"], ref["markerdata"],
                                  what)
    for k in KEYS:
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_driver_matches_jax_mesh(groups, world):
    """The port's F2 Driver over a gloo mesh of ``world`` ranks against
    the JAX Driver over ``make_mesh(world)`` of the 8 virtual CPU devices
    (both resident; the JAX Driver with the port's rules), iteration by
    iteration."""
    from cnf2freq_tpu.driver import Driver as JaxDriver
    from cnf2freq_tpu.parallel import make_mesh as jax_mesh
    from cnf2freq_tpu.utils.simulate import simulate_f2 as jax_simulate

    seen = {"anchors": [], "winners": [], "flat": [], "scored": [],
            "negshift_ties": []}
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_with_port_rules(mp, seen)
        ped = jax_simulate(n_f2=8, **worker.F2)
        dj = JaxDriver(ped, dtype=np.float64, mesh=jax_mesh(world))
        assert dj._use_resident()
        dj.preprocess()
        infos = [dj.iterate(early=(i == 0)) for i in range(3)]
    inds = ped.inds[1:]
    ref = dict(hitnnn=np.array([i["hitnnn"] for i in infos]),
               inverted=np.array([i["inverted"] for i in infos]),
               scalefactor=np.array([i["scalefactor"] for i in infos]),
               haploweight=np.stack([i.haploweight for i in inds]),
               markerdata=np.stack([i.markerdata for i in inds]),
               markersure=np.stack([i.markersure for i in inds]),
               relhaplo=np.stack([i.relhaplo for i in inds]),
               pair=np.stack([dj.pair_tables[n] for n in ped.dous]))
    got = case_arrays(results(groups, world), "f2")
    assert_same_run(got, ref, f"{world} ranks against JAX")


def test_merges_under_group_match_jax_shard_map(groups):
    """merge_haplos / merge_infprobs / merge_slot_stats with group= under
    2 ranks against the JAX merges with axis_name under shard_map on a
    2-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from cnf2freq_tpu.parallel import collective as jc

    x = worker.rand_merge_inputs()
    NI = x["NI"]
    lut = x["lut"].astype(np.int32)

    def step(b12, mask, hw, slot_ind, desc, accum, values, lut):
        hb, hc = jc.merge_haplos(b12, mask, hw, slot_ind, desc, lut, NI,
                                 axis_name="data")
        inf = jc.merge_infprobs(accum, slot_ind, desc, lut, NI,
                                axis_name="data")
        vals = jc.merge_slot_stats(values, slot_ind, NI, axis_name="data")
        return hb, hc, inf, vals

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    d = P("data")
    fn = jax.jit(jax.shard_map(step, mesh=mesh,
                               in_specs=(d, d, d, d, d, d, d, P()),
                               out_specs=(P(), P(), P(), P()),
                               check_vma=False))
    hb, hc, inf, vals = fn(*(jnp.asarray(x[k]) for k in (
        "b12", "mask", "hw", "slot_ind", "desc", "accum", "values")),
        jnp.asarray(lut))
    got = case_arrays(results(groups, 2), "merges")
    for name, ref in (("hb", hb), ("hc", hc), ("inf", inf),
                      ("slot_stats", vals)):
        np.testing.assert_allclose(got[name], np.asarray(ref), rtol=1e-12,
                                   atol=1e-15, err_msg=name)


@pytest.mark.parametrize("world,case", [(w, c) for w, cs in CASES.items()
                                        for c in cs
                                        if c not in ("merges", "diverge")])
def test_mesh_driver_matches_unmeshed(groups, world, case):
    """Driver(mesh=make_mesh(world)): F2 on both iteration branches (with
    chunks that the data size does not divide, and several chunks an
    iteration), the ng2 and selfed families (with padded units), map
    re-estimation, parity mode and a marker-blocked chromosome (run whole
    on every rank), against the port's unmeshed Driver on the same
    cohort."""
    ref, _ = worker.run_driver(case)
    got = case_arrays(results(groups, world), case)
    assert set(got) == set(ref)
    assert_same_run(got, ref, f"{world} ranks, {case}")


def test_ranks_that_disagree_raise(groups):
    """A rank whose state departs (here its scalefactor) makes every rank
    raise at the end of the iteration (the state digest's all-reduce),
    rather than run on apart."""
    ranks = results(groups, 2)
    assert [bool(r["diverge/raised"]) for r in ranks] == [True, True]


def test_mesh_checkpoint_shards_resume_unmeshed(groups, tmp_path):
    """The 2-rank F2 run wrote one shard per rank and the manifest; a
    fresh unmeshed Driver loads the set (every rank's state, to the
    dump's printed precision), takes the exported state and resumes."""
    d = groups[2][0] / "ckpt"
    got = case_arrays(results(groups, 2), "f2")
    assert sorted(os.listdir(d)) == ["manifest.json",
                                     "shard-00000-of-00002.txt",
                                     "shard-00001-of-00002.txt"]
    ped = simulate_f2(n_f2=8, **worker.F2)
    drv = Driver(ped, dtype=torch.float64, device="cpu")
    drv.preprocess()
    man = load_sharded(ped, str(d))
    drv.import_state(man["driver"])
    assert drv.state.iter == 3
    np.testing.assert_array_equal(
        np.stack([i.markerdata for i in ped.inds[1:]]), got["markerdata"])
    np.testing.assert_allclose(
        np.stack([i.haploweight for i in ped.inds[1:]]), got["haploweight"],
        atol=5e-7)
    np.testing.assert_allclose(
        np.stack([i.markersure for i in ped.inds[1:]]), got["markersure"],
        atol=5e-7)
    info = drv.iterate()
    assert drv.state.iter == 4 and np.isfinite(info["loglik"])


def test_sharded_checkpoints_cross_packages(tmp_path):
    """A 4-shard set written by the JAX package loads in the port and the
    reverse, and both write byte-identical shard files and manifests for
    the same state."""
    from cnf2freq_tpu.io import sharded_checkpoint as jck
    from cnf2freq_tpu.utils.simulate import simulate_f2 as jax_simulate

    from cnf2freq_tpu_torch.pedigree import from_host

    jped = jax_simulate(n_f2=10, n_markers=8, seed=7)
    rng = np.random.default_rng(5)
    for ind in jped.inds[1:]:
        ind.haploweight[:] = rng.uniform(0, 1, ind.haploweight.shape)
        ind.markersure[:] = rng.uniform(0, 0.3, ind.markersure.shape)
    pped = from_host(jped)
    meta = {"iteration": 5, "driver": {"scalefactor": 0.01, "iter": 5}}
    jck.save_sharded(jped, str(tmp_path / "jax"), meta=meta,
                     process_count=4)
    save_sharded(pped, str(tmp_path / "torch"), meta=meta, process_count=4)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert len([n for n in names if n.startswith("shard-")]) == 4
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "torch" / n).read_bytes(), n

    def loaded(ped, load, src):
        man = load(ped, str(tmp_path / src))
        assert man["iteration"] == 5 and man["driver"]["iter"] == 5
        return np.stack([i.haploweight for i in ped.inds[1:]]), \
            np.stack([i.markersure for i in ped.inds[1:]])

    into_port = loaded(from_host(jax_simulate(n_f2=10, n_markers=8, seed=7)),
                       load_sharded, "jax")
    into_jax = loaded(jax_simulate(n_f2=10, n_markers=8, seed=7),
                      jck.load_sharded, "torch")
    for a, b, want in zip(into_port, into_jax, (
            np.stack([i.haploweight for i in jped.inds[1:]]),
            np.stack([i.markersure for i in jped.inds[1:]]))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, want, atol=5e-7)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_of_one_rank_is_bit_identical(one_rank_group):
    """At world size 1 the all-reduce is the identity: the meshed F2
    Driver (resident) ends bit for bit where the unmeshed one does."""
    ref, _ = worker.run_driver("f2")
    got, drv = worker.run_driver("f2", mesh=make_mesh(1))
    assert drv.device == torch.device("cpu")
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_rejected_collective_raises(one_rank_group):
    """A tensor the backend rejects raises; nothing is staged through the
    host in its place (gloo sums no int16)."""
    with pytest.raises(RuntimeError):
        all_sum([torch.ones(3, dtype=torch.int16)], dist.group.WORLD)


def test_no_process_group_no_mesh(monkeypatch):
    """Without a process group make_mesh raises; init_distributed is a
    no-op with nothing configured and raises on a partial
    configuration."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    init_distributed()
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="all needed"):
        init_distributed()
    assert not dist.is_initialized()


def test_pad_and_shard_batch():
    """pad_batch appends vacant units (slot ids 0, shiftignore =
    flag2ignore = 0, weights 0.5) up to a multiple of the data size, and
    the ranks' blocks (shard_batch) tile the padded chunk in order."""
    ped = simulate_f2(n_f2=5, n_markers=4, seed=2)
    fb = gather_family(ped, ped.dous, 0, 3)
    p = pad_batch(fb, 4)
    assert p.slot_ind.shape[0] == 8
    np.testing.assert_array_equal(p.slot_ind[:5], fb.slot_ind)
    assert (p.slot_ind[5:] == 0).all() and not p.exists[5:].any()
    assert (p.shiftignore[5:] == 0).all() and (p.flag2ignore[5:] == 0).all()
    assert (p.hw[5:] == 0.5).all() and (p.md[5:] == 0).all()
    assert pad_batch(p, 4) is p

    class Mesh:        # the two DeviceMesh calls batch_sharding makes
        def __init__(self, r):
            self.r = r
            self.mesh_dim_names = ("data", "state")

        def size(self, dim):
            return 4

        def get_local_rank(self, name):
            return self.r

    blocks = [shard_batch(p, Mesh(r)).slot_ind for r in range(4)]
    assert all(b.shape[0] == 2 for b in blocks)
    np.testing.assert_array_equal(np.concatenate(blocks), p.slot_ind)
