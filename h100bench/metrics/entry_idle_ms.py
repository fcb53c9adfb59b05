"""Device idle ms per call while the host's innermost program span was
``naf.call``: the entry's own work (casts, NCHW to NHWC, ``contiguous``)
outside the encoder, keys and attention spans."""

from h100bench.metrics.program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "naf.call")
