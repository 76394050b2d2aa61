"""Multi-GPU and multi-host execution (port of
``cnf2freq_tpu/parallel/multihost.py``).

The reference's only multi-node story is an ifdef'd-out Boost.MPI loop
(rank-0 broadcast of parameters, elementwise reduce of the accumulators,
round-robin individual assignment, cnF2freq.cpp:5197-5242, 6245-6255).
The JAX package runs one multi-controller program over a pod; the port
runs PyTorch's SPMD form of it: one process per GPU, every process
running the same Driver program, ``torch.distributed`` wiring them into
one process group (NCCL between cards, gloo on the CPU), a
``DeviceMesh`` over every rank (``pod_mesh``), and the all-reduces of
``parallel.collective`` in place of the psum.  The host stages (flip
solve, capped-gradient updates, scalefactor) consume the summed
accumulators, so every rank computes identical updates: no rank-0
special casing and no parameter broadcast.

Typical run, one process per card on each host::

    torchrun --nproc-per-node=4 run.py          # one host, four cards
    torchrun --nnodes=2 --nproc-per-node=8 --rdzv-backend=c10d \\
        --rdzv-endpoint=HOST:29400 run.py       # two hosts

where run.py holds::

    from cnf2freq_tpu_torch import Driver
    from cnf2freq_tpu_torch.parallel.multihost import (init_distributed,
                                                       pod_mesh)
    import torch, torch.distributed as dist
    init_distributed()                  # reads torchrun's environment
    drv = Driver(ped, dtype=torch.float32, mesh=pod_mesh())
    drv.preprocess()
    drv.run(iterations)
    if dist.get_rank() == 0:
        ...write outputs...

Sizing: each rank scans ceil(B / ranks) units of a chunk of B, and the
chunk is sized from the card's free memory (``Driver.batch_size="auto"``,
the smallest size over the ranks); the per-individual state and the
accumulators ([NI, M]) are held whole on every rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import make_mesh

# how long a collective (and the rendezvous) may wait for a rank before
# the process group raises: a rank that fails leaves the others waiting
TIMEOUT_S = 600.0


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S,
                     backend: Optional[str] = None) -> None:
    """Join this process to the process group.

    The arguments, or torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): ``coordinator`` is an
    ``init_method`` URL (``tcp://host:port`` or ``file://path``).  The
    backend is ``backend``, or by default NCCL on a machine with a card
    and gloo without one; under NCCL the process takes the card
    ``LOCAL_RANK`` (default: its rank modulo the cards).  ``make_mesh``
    reads the device type from the backend, so ``backend="gloo"`` runs
    a CPU mesh on a machine with cards.  A no-op when the group is
    already up or when nothing is configured (a single-process run); a
    partial configuration, or a rendezvous that fails, raises: a
    multi-process run never degrades to a single-process one in
    silence."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    given = (coordinator, num_processes, process_id)
    if all(v is None for v in given):
        return
    if any(v is None for v in given):
        raise ValueError(
            "init_distributed: a coordinator, a process count and a "
            f"process id are all needed (got {given}); set MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK, or pass all three")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=coordinator, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def pod_mesh(state: int = 1, device_type: Optional[str] = None):
    """A data-parallel mesh over every rank of every host (the same call
    shapes single-host and multi-host runs); ``device_type`` as in
    ``make_mesh``."""
    return make_mesh(data=dist.get_world_size() // state, state=state,
                     device_type=device_type)


def local_cohort_slice(n_units: int) -> slice:
    """The contiguous block of ``n_units`` analysis units that this rank
    owns (the split of ``mesh.batch_sharding`` and of the sharded
    checkpoint): ceil(n_units / ranks) a rank, the last one shorter."""
    p, n = dist.get_rank(), dist.get_world_size()
    per = -(-n_units // n)
    return slice(p * per, min((p + 1) * per, n_units))
