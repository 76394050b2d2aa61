"""Device-mesh scaling (port of ``cnf2freq_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` whose
``data`` axis carries the analysis units and whose ``state`` axis is kept
for state-space model parallelism.  The port takes PyTorch's idiom: one
process per GPU (SPMD) in a ``torch.distributed`` process group, and a
``DeviceMesh`` with the same dimension names, ``("data", "state")``.
Every rank builds the same Driver on the same Pedigree; each chunk of
analysis units is padded to a multiple of the data size (``pad_batch``)
and each rank takes its contiguous block of it (``shard_batch``, the
rank's share of JAX's ``P("data")``); the merged accumulators are summed
over the ranks (``parallel.collective``) where JAX uses ``psum``.

``pad_markers`` pads the marker axis for the marker-blocked scan.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..hmm.family import FamilyBatch

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              state: int = 1, device_type: Optional[str] = None
              ) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the process group, shaped
    (data, state) with ``mesh_dim_names=("data", "state")``.  Its device
    type is ``device_type``, or by default the process group's: "cuda"
    under NCCL, "cpu" under any other backend (gloo carries CUDA tensors
    too: pass "cuda" for such a group).

    Needs an initialised process group (``multihost.init_distributed``)
    and raises without one: no call here falls back to a one-device run.
    ``n_devices``, where given, must be the group's world size (a rank
    outside the mesh would wait in its collectives)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: call "
            "parallel.multihost.init_distributed() (or "
            "torch.distributed.init_process_group) in every rank first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh({n_devices}) in a process group of "
                         f"{n} ranks: the mesh spans every rank")
    if data is None:
        data = n // state
    if data * state != n:
        raise ValueError(f"data={data} x state={state} != {n} ranks")
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(data, state),
                      mesh_dim_names=("data", "state"))


def data_size(mesh: DeviceMesh) -> int:
    """The number of ranks along "data" (the units' split)."""
    return mesh.size(mesh.mesh_dim_names.index("data"))


def data_rank(mesh: DeviceMesh) -> int:
    """This rank's coordinate along "data"."""
    return mesh.get_local_rank("data")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The rank's device: its current card for a "cuda" mesh (the one
    ``init_distributed`` selected from LOCAL_RANK), else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh: DeviceMesh, n_units: int) -> slice:
    """The rank's contiguous block of a chunk of ``n_units`` units padded
    to a multiple of the data size (``pad_batch``): JAX's ``P("data")``
    seen from one rank."""
    per = -(-n_units // data_size(mesh))
    r = data_rank(mesh)
    return slice(r * per, (r + 1) * per)


def _map_batch(fb: FamilyBatch, fn) -> FamilyBatch:
    return dataclasses.replace(fb, **{
        f.name: fn(getattr(fb, f.name)) for f in dataclasses.fields(fb)
        if getattr(fb, f.name) is not None})


def pad_batch(fb: FamilyBatch, multiple: int) -> FamilyBatch:
    """Pad the unit axis of a numpy batch to a multiple of ``multiple``.
    Padded units are vacant families (no slot occupied, slot ids 0, so
    every merge drops them) with ``shiftignore = flag2ignore = 0``;
    genotypes unknown, weights and relhaplo 0.5 (the resident cohort's
    vacant-slot values).  Callers read real units only."""
    B = fb.slot_ind.shape[0]
    pad = (-B) % multiple
    if pad == 0:
        return fb
    fill = {"hw": 0.5, "relh": 0.5}

    def padb(x):
        x = np.asarray(x)
        tail = np.zeros((pad,) + x.shape[1:], dtype=x.dtype)
        return np.concatenate([x, tail], axis=0)

    out = _map_batch(fb, padb)
    for name, v in fill.items():
        x = getattr(out, name)
        if x is not None:
            x[B:] = v
    out.shiftignore[B:] = 0
    out.flag2ignore[B:] = 0
    return out


def shard_batch(fb: FamilyBatch, mesh: DeviceMesh) -> FamilyBatch:
    """The rank's rows (``batch_sharding``) of a batch padded by
    ``pad_batch`` to a multiple of the data size."""
    sl = batch_sharding(mesh, fb.slot_ind.shape[0])
    return _map_batch(fb, lambda x: x[sl])


def replicate(x, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` as a tensor on the rank's device (every rank holds it
    whole, JAX's ``P()``)."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=mesh_device(mesh))


def pad_markers(fb: FamilyBatch, m_target: int) -> FamilyBatch:
    """Pad the marker axis to m_target with inert trailing markers
    (all-unknown genotypes, zero error, neutral phase weight, relhaplo 0.5
    where the batch carries it): the tensor form of the reference's
    mandatory trailing dummy marker (demo.sh:22-23).  With zero
    inter-marker distance the transition is the identity and the padded
    emissions are state-constant, so real markers' posteriors are
    unchanged; callers slice results back to the real length.  Takes
    numpy arrays or tensors."""
    M = fb.md.shape[2]
    pad = m_target - M
    if pad <= 0:
        return fb

    def padm(x, val):
        if torch.is_tensor(x):
            tail = torch.full(x.shape[:2] + (pad,) + x.shape[3:], val,
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], dim=2)
        widths = [(0, 0), (0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 3)
        return np.pad(np.asarray(x), widths, constant_values=val)

    relh = fb.relh
    if relh is not None:
        # the RELSKEWSTATES coupling of the padded intervals: no skew
        relh = padm(relh[:, None], 0.5)[:, 0]
    return dataclasses.replace(fb, md=padm(fb.md, 0), ms=padm(fb.ms, 0.0),
                               hw=padm(fb.hw, 0.5), relh=relh)
