"""Build and bind the CUDA kernels of ``csrc/``.

The kernels are compiled at first use with ``nvcc`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers: the build takes seconds, not minutes).  Every exported function
is ``int cnf_<kernel>_<f32|f64>(..., void* stream)`` and returns the
``cudaError_t`` of its launch.

The library goes to ``$CNF2FREQ_TORCH_BUILD`` if set, else to
``build/kernels/`` beside the package; its file name carries a hash of
the sources and flags, so a stale build is never loaded.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_LOCK = threading.Lock()
_LIB = None

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def build_dir() -> str:
    return os.environ.get("CNF2FREQ_TORCH_BUILD") or os.path.join(
        os.path.dirname(_HERE), "build", "kernels")


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) +
                  glob.glob(os.path.join(_CSRC, "*.cuh")))


def load_kernels(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use.  ``verbose`` adds
    ``-Xptxas -v`` to a fresh build and writes the compiler's report to
    ptxas.txt in the build directory."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources():
            with open(src, "rb") as f:
                h.update(os.path.basename(src).encode() + f.read())
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        lib_path = os.path.join(out_dir,
                                f"libcnf2freq_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [_nvcc()] + flags + ["-o", tmp] + \
                [s for s in sources() if s.endswith(".cu")]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
            if verbose:
                with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
                    f.write(r.stdout + r.stderr)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.cnf_error_string.restype = ctypes.c_char_p
        lib.cnf_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib


def check_config(cfg) -> None:
    """The kernels are written for the default F2 state space: 64
    inheritance states x 8 shift modes over 7 family slots."""
    if not (cfg.numgen == 3 and cfg.haplotyping and not cfg.selfing
            and not cfg.relskewstates and cfg.numtypes == 64
            and cfg.numshifts == 8 and cfg.numslots == 7
            and cfg.numturns == 128):
        raise NotImplementedError(
            "the CUDA kernels cover the default F2 haplotyping model only")


def check(t: torch.Tensor, dtype, shape, name: str) -> None:
    if not torch.is_tensor(t) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(kernel: str, dtype, *args) -> None:
    """Call ``cnf_<kernel>_<f32|f64>`` with tensors as device pointers,
    Python ints as C ints and Python floats in the kernel's float type,
    on the current stream; raise on a non-zero cudaError_t."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel}: float32 or float64 only, got {dtype}")
    lib = load_kernels()
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(lib, f"cnf_{kernel}_{suffix}")
    cfloat = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
    cargs, types = [], []
    for a in args:
        if torch.is_tensor(a):
            cargs.append(ctypes.c_void_p(a.data_ptr()))
            types.append(ctypes.c_void_p)
        elif isinstance(a, int):
            cargs.append(ctypes.c_int(a))
            types.append(ctypes.c_int)
        elif isinstance(a, float):
            cargs.append(cfloat(a))
            types.append(cfloat)
        else:
            raise TypeError(f"{kernel}: unsupported argument {type(a)}")
    stream = torch.cuda.current_stream().cuda_stream
    cargs.append(ctypes.c_void_p(stream))
    types.append(ctypes.c_void_p)
    fn.argtypes = types
    fn.restype = ctypes.c_int
    err = fn(*cargs)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.cnf_error_string(err).decode()}")
