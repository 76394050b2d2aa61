"""cnf2freq_tpu_torch: the pedigree-HMM framework on PyTorch and CUDA.

A port of ``cnf2freq_tpu`` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (``csrc/``, built with nvcc at first use).
It imports ``torch`` and never ``jax``; from the JAX package it uses only
the JAX-free host modules (config, pedigree, io, utils.simulate,
utils.harness, native).
"""

from .driver import Driver, copy_pedigree

__all__ = ["Driver", "copy_pedigree"]
