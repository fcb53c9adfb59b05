"""Device idle ms per call while the host's innermost program span was
``naf.keys``."""

from h100bench.metrics.program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "naf.keys")
