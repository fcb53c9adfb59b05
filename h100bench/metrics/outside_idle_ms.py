"""Device idle ms per call while no program span was open on the host: the
caller between calls (its wait, timing and loop)."""

from h100bench.metrics.program_spans import OUTSIDE, idle_ms


def read(ctx):
    return idle_ms(ctx, OUTSIDE)
