"""The benchmark of the PyTorch and CUDA port (`repro_torch`); see run.py."""
