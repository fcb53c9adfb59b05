"""Device time per step of the attention's backward: the operations under
the program's ``naf.attention.backward`` spans (K2's twin recomputed: the
pool-up, RoPE and K3; K4 and its reduce pass; their gradients' glue), in
ms. A program without the span reads None."""

from h100bench.metrics.program_spans import device_ms


def read(ctx):
    return device_ms(ctx, "naf.attention.backward")
