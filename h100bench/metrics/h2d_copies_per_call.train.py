"""Host-to-device copies per training step charged to the program's spans,
read as h2d_copies_per_call reads them, over the profiled chunk."""

from h100bench.metrics.h2d_copies_per_call import read  # noqa: F401
