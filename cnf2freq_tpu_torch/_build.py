"""Build and bind the CUDA kernels of ``csrc/``.

The kernels are compiled at first use into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers: the build
takes seconds, not minutes).  Each ``csrc/*.cu`` file is compiled to an
object by its own ``nvcc`` process, all started together, and the
objects are linked once.  Every exported function is
``int cnf_<kernel>_<f32|f64>(..., void* stream)`` and returns the
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
              "-O3", "-Xcompiler", "-fPIC"]


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
    """The kernel sources, one object each."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _build(lib_path: str, verbose: bool) -> None:
    """Compile every source to an object, one nvcc each, all at once;
    link them into ``lib_path``."""
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    tmp = f"{lib_path}.{os.getpid()}"
    os.makedirs(tmp + ".d", exist_ok=True)
    try:
        jobs = []
        for src in sources():
            obj = os.path.join(tmp + ".d", os.path.basename(src) + ".o")
            proc = subprocess.Popen([nvcc] + flags + ["-c", src, "-o", obj],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        reports, failed = [], []
        for src, _, proc in jobs:
            text = proc.communicate()[0]
            reports.append(f"== {os.path.basename(src)}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{text}")
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        r = subprocess.run([nvcc, "-shared"] + NVCC_FLAGS[:2] +
                           ["-o", tmp + ".so"] + [o for _, o, _ in jobs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + r.stdout + r.stderr)
        if verbose:
            with open(os.path.join(build_dir(), "ptxas.txt"), "w") as f:
                f.write("\n".join(reports))
        os.replace(tmp + ".so", lib_path)
    finally:
        shutil.rmtree(tmp + ".d", ignore_errors=True)


def load_kernels(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use.  ``verbose`` adds
    ``-Xptxas -v`` to a fresh build and writes the compilers' reports to
    ptxas.txt in the build directory."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources() + sorted(glob.glob(os.path.join(_CSRC,
                                                             "*.cuh"))):
            with open(src, "rb") as f:
                h.update(os.path.basename(src).encode() + f.read())
        os.makedirs(build_dir(), exist_ok=True)
        lib_path = os.path.join(build_dir(),
                                f"libcnf2freq_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(lib_path):
            _build(lib_path, verbose)
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


def check_ext_config(cfg) -> int:
    """The extended spaces' kernels (#13, #14) are written for the 7-slot
    haplotyping model with one extension: SELFING (V = 3) or
    RELSKEWSTATES (V = 2).  Returns V."""
    if not (cfg.numgen == 3 and cfg.haplotyping
            and cfg.selfing != cfg.relskewstates and cfg.numtypes == 64
            and cfg.numshifts == 8 and cfg.numslots == 7):
        raise NotImplementedError(
            "the extended kernels cover the SELFING and RELSKEWSTATES "
            "haplotyping models only")
    return 3 if cfg.selfing else 2


def check_form(t: torch.Tensor, dtype, shape, name: str) -> None:
    """Raise unless ``t`` is a tensor of ``dtype`` and ``shape``, on any
    device."""
    if not torch.is_tensor(t):
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def check(t: torch.Tensor, dtype, shape, name: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``."""
    check_form(t, dtype, shape, name)
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(kernel: str, dtype, *args) -> None:
    """Call ``cnf_<kernel>_<f32|f64>`` with tensors as device pointers,
    ``None`` as a null pointer, Python ints as C ints and Python floats in
    the kernel's float type, on the current stream; raise on a non-zero
    cudaError_t."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel}: float32 or float64 only, got {dtype}")
    lib = load_kernels()
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(lib, f"cnf_{kernel}_{suffix}")
    cfloat = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
    cargs, types = [], []
    for a in args:
        if torch.is_tensor(a) or a is None:
            cargs.append(ctypes.c_void_p(None if a is None else a.data_ptr()))
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
