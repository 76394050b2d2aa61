"""cnf2freq_tpu_torch: the pedigree-HMM framework on PyTorch and CUDA.

A port of ``cnf2freq_tpu`` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (``csrc/``, built with nvcc at first use).
It imports ``torch`` and never ``jax``, and nothing of ``cnf2freq_tpu``:
it keeps its own copies of the JAX-free host modules it needs (``config``,
``pedigree``, ``utils.simulate``, ``native``); ``pedigree.from_host``
carries a pedigree of either package over.  ``Driver`` runs on the card
unless it is given ``device="cpu"``.
"""

from .driver import Driver, copy_pedigree

__all__ = ["Driver", "copy_pedigree"]
