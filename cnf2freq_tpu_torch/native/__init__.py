"""Native (C++) host-side components of the port.

``flipsolve.cc`` is the per-component search core of the phase-flip
optimiser (the port's copy of ``cnf2freq_tpu/native/flipsolve.cc``).  It
is compiled with g++ at first use into the build directory of the CUDA
kernels (``_build.build_dir()``, gitignored), under a file name that
carries a hash of the source, and bound with ctypes.  A failed build
raises: the solver has no silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _compile(src: str, out: str) -> None:
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(["g++"] + GXX_FLAGS + [src, "-o", tmp],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError("g++ failed on flipsolve.cc:\n" + r.stdout +
                           r.stderr)
    os.replace(tmp, out)


def load_flipsolve() -> ctypes.CDLL:
    """The flip-solver library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from .._build import build_dir
        src = os.path.join(_HERE, "flipsolve.cc")
        with open(src, "rb") as f:
            h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + f.read())
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"libflipsolve_{h.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            _compile(src, out)
        lib = ctypes.CDLL(out)
        lib.flip_solve_component.restype = ctypes.c_double
        lib.flip_solve_component.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),   # fam_nv
            ctypes.POINTER(ctypes.c_int32),   # vpos
            ctypes.POINTER(ctypes.c_int64),   # s_off
            ctypes.POINTER(ctypes.c_double),  # scores
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.flip_solve_component_v2.restype = ctypes.c_double
        lib.flip_solve_component_v2.argtypes = \
            lib.flip_solve_component.argtypes[:-1] + \
            [ctypes.POINTER(ctypes.c_uint8)]  # out_vec, no 64-var limit
        _LIB = lib
        return _LIB
