"""hmm of the PyTorch/CUDA port (mirrors cnf2freq_tpu/hmm)."""
