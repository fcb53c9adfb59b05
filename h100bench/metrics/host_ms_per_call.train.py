"""Host time of one training step, read as host_ms_per_call reads it, over
the profiled chunk's steps."""

from h100bench.metrics.host_ms_per_call import read  # noqa: F401
