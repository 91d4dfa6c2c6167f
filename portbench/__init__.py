"""The benchmark of the PyTorch and CUDA port: a harness driven by data (see run.py)."""
