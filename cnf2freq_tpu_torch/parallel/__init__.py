"""parallel of the PyTorch/CUDA port (mirrors cnf2freq_tpu/parallel)."""
