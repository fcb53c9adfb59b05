"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its plain
PyTorch version in the same module. Nothing is built at import time."""
