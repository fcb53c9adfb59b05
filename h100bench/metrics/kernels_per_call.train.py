"""Device operations per training step, read as kernels_per_call reads them,
over the profiled chunk."""

from h100bench.metrics.kernels_per_call import read  # noqa: F401
