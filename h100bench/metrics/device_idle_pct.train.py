"""The idle share of the device over the profiled training chunk, read as
device_idle_pct reads it."""

from h100bench.metrics.device_idle_pct import read  # noqa: F401
