"""Model families of the PyTorch/CUDA port beyond the default F2 model
(mirrors cnf2freq_tpu/models)."""
