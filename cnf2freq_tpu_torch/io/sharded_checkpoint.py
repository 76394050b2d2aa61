"""Sharded checkpoints for multi-process runs (the port's copy of
``cnf2freq_tpu/io/sharded_checkpoint.py``, kept in step with it: the same
files, so a shard set written by either package loads in the other).

The single-file checkpoint (``write_haplotype_dump`` + ``deserialize``,
the reference's dump/--deserialize contract, cnF2freq.cpp:7757-7832,
8157-8194) serialises every individual through one stream.  Here the
same dump format is split into per-process shard files plus a JSON
manifest:

    <dir>/manifest.json                  {"shards": N, "iteration": ...}
    <dir>/shard-00000-of-00008.txt       dump rows for its id range

Every process writes only the individuals in its shard (by id order, the
contiguous split of ``parallel.multihost.local_cohort_slice``); every
process reads ALL shards on resume, because the host-side update stages
need the whole state.  Shard files reuse the reference dump row format,
so a shard set concatenates into a file the plain ``deserialize`` (and
the reference binary's --deserialize) accepts.  The process index and
count come from ``torch.distributed`` where its group is up, else from
the arguments (one process by default)."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch.distributed as dist

from ..pedigree import Pedigree
from .outputs import deserialize, write_haplotype_dump


def _shard_name(k: int, n: int) -> str:
    return f"shard-{k:05d}-of-{n:05d}.txt"


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def save_sharded(ped: Pedigree, dirpath: str,
                 meta: Optional[dict] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> None:
    """Write this process's shard (all shards when single-process).

    Atomic per shard (tmp + rename); the manifest is written by process
    0 after its shard."""
    np_ = _process_count() if process_count is None else process_count
    os.makedirs(dirpath, exist_ok=True)

    inds = [i for i in ped.inds[1:] if i is not None
            and i.haploweight is not None]
    per = -(-len(inds) // np_)

    def write_shard(k):
        path = os.path.join(dirpath, _shard_name(k, np_))
        tmp = path + ".tmp"
        sub = inds[k * per:(k + 1) * per]
        with open(tmp, "w") as f:
            write_haplotype_dump(ped, f, reset_negshift=False, inds=sub)
        os.replace(tmp, path)

    if process_index is not None:
        p = process_index
        write_shard(p)
    elif _process_count() == 1:
        # single process (possibly emulating an np_-shard layout): write
        # every shard
        p = 0
        for k in range(np_):
            write_shard(k)
    else:
        p = dist.get_rank()
        write_shard(p)
    if p == 0:
        man = dict(meta or {})
        man["shards"] = np_
        tmp = os.path.join(dirpath, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(man, f)
        os.replace(tmp, os.path.join(dirpath, "manifest.json"))


def load_sharded(ped: Pedigree, dirpath: str) -> dict:
    """Read the manifest + every shard into the pedigree; returns the
    manifest dict (iteration counter, driver state, ...) with the
    phase-switch counts under "switches"."""
    with open(os.path.join(dirpath, "manifest.json")) as f:
        man = json.load(f)
    n = man["shards"]
    switches: Dict[int, int] = {}
    for k in range(n):
        with open(os.path.join(dirpath, _shard_name(k, n))) as f:
            switches.update(deserialize(ped, f))
    man["switches"] = switches
    return man
