"""The benchmark of the PyTorch/CUDA port (``naf_torch``) on one NVIDIA
H100: ``python3 -m h100bench --workload CELL --seed N --seconds S --trace
0|1``. See ``h100bench/README.md``."""
