"""parallel of the PyTorch/CUDA port (mirrors cnf2freq_tpu/parallel)."""
from .mesh import (batch_sharding, make_mesh, pad_batch, replicate,
                   shard_batch)
from .multihost import init_distributed, local_cohort_slice, pod_mesh

__all__ = ["batch_sharding", "make_mesh", "pad_batch", "replicate",
           "shard_batch", "init_distributed", "pod_mesh",
           "local_cohort_slice"]
