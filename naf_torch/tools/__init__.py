"""Measurement scripts for the port's kernels, run on a CUDA machine with
``python -m naf_torch.tools.<name>``. Importing them does nothing."""
