"""Host <-> device copies that do not stall the host.

A blocking host-to-device copy from pageable memory, a device-to-host
copy and ``.item()`` each wait for the card to drain its queue.  The
helpers here keep such waits to the ones that are needed:

* ``constant``: a small constant array on a device, built once per
  (values, device, dtype) and reused, so that a scan does not copy its
  index tables to the card on every call;
* ``upload``: a host array on a device through pinned memory and a
  non-blocking copy (a fresh tensor, never an alias of the array);
* ``fetch``: several device tensors to numpy with one synchronisation.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def constant(values, device, dtype: torch.dtype = None) -> torch.Tensor:
    """``torch.as_tensor(values, dtype, device)``, made once per
    (values, device, dtype); callers must not modify it."""
    a = np.ascontiguousarray(values)
    key = (a.tobytes(), a.shape, a.dtype.str, str(torch.device(device)),
           dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return t


def upload(x, device, dtype: torch.dtype = None) -> torch.Tensor:
    """A copy of the host array ``x`` on ``device``; on the card the copy
    runs from pinned memory without blocking the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.tensor(np.asarray(x), dtype=dtype)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None:
        t = t.to(dtype)
    return t.pin_memory().to(device, non_blocking=True)


def fetch(tensors: Sequence[torch.Tensor]) -> list:
    """numpy copies of device tensors, with one wait for the card."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy().copy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]
