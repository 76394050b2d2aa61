"""Native (C++) host-side components of the port.

* ``flipsolve.cc``: the per-component search core of the phase-flip
  optimiser (the port's copy of ``cnf2freq_tpu/native/flipsolve.cc``).
* ``genread.cc``: the PlantImpute ``.gen`` reader (the port's copy of
  ``cnf2freq_tpu/native/genread.cc``, with a binomial coefficient that
  matches the Python reader bit for bit up to 120 reads).

Each is compiled with g++ at first use into the build directory of the
CUDA kernels (``_build.build_dir()``, gitignored), under a file name that
carries a hash of the source and flags, and bound with ctypes.  A failed
build raises: neither has a silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# no FMA contraction: the .gen reader's read-count model must round as the
# Python reader does
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]


def _compile(src: str, out: str) -> None:
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(["g++"] + GXX_FLAGS + [src, "-o", tmp],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on {os.path.basename(src)}:\n"
                           + r.stdout + r.stderr)
    os.replace(tmp, out)


def _load(name: str) -> ctypes.CDLL:
    """``<name>.cc`` as a shared library, built on first use."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        from .._build import build_dir
        src = os.path.join(_HERE, f"{name}.cc")
        with open(src, "rb") as f:
            h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + f.read())
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"lib{name}_{h.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            _compile(src, out)
        _LIBS[name] = ctypes.CDLL(out)
        return _LIBS[name]


def load_flipsolve() -> ctypes.CDLL:
    """The flip-solver library, built on first use."""
    lib = _load("flipsolve")
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
    return lib


def load_genread() -> ctypes.CDLL:
    """The .gen reader library, built on first use."""
    lib = _load("genread")
    lib.gen_load.restype = ctypes.c_void_p
    lib.gen_load.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int,
    ]
    lib.gen_names_len.restype = ctypes.c_int64
    lib.gen_names_len.argtypes = [ctypes.c_void_p]
    lib.gen_names.restype = None
    lib.gen_names.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.gen_copy.restype = None
    lib.gen_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.gen_free.restype = None
    lib.gen_free.argtypes = [ctypes.c_void_p]
    return lib


def parse_gen_native(path: str, m: int, genotype_error: float):
    """(names, md [n, m, 2] int32, ms [n, m, 2] f64, rc [n, m] bool) of a
    .gen file.  A missing file raises FileNotFoundError, as the Python
    reader's ``open`` does; malformed input raises ValueError with the
    parser's message, which names the individual."""
    import numpy as np
    with open(path, "rb"):    # the OSError of a missing or unreadable file
        pass
    lib = load_genread()
    n = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(512)
    h = lib.gen_load(os.fsencode(path), m, genotype_error,
                     ctypes.byref(n), err, len(err))
    if not h:
        msg = err.value.decode(errors="replace")
        raise ValueError(msg or f"failed to parse {path}")
    try:
        nl = lib.gen_names_len(h)
        nbuf = ctypes.create_string_buffer(int(nl) + 1)
        lib.gen_names(h, nbuf)
        names = nbuf.raw[:nl].decode().split("\n") if nl else []
        nv = int(n.value)
        md = np.empty((nv, m, 2), dtype=np.int32)
        ms = np.empty((nv, m, 2), dtype=np.float64)
        rc = np.empty((nv, m), dtype=np.uint8)
        lib.gen_copy(h, md.ctypes.data_as(ctypes.c_void_p),
                     ms.ctypes.data_as(ctypes.c_void_p),
                     rc.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.gen_free(h)
    return names, md, ms, rc.astype(bool)
