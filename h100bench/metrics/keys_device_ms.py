"""Device time per call of the keys and RoPE tables: the operations under the
program's ``naf.keys`` span (``RoPE.pooled``, ``RoPE.tables``, the casts and
copies around them), in ms."""

from h100bench.metrics.program_spans import device_ms


def read(ctx):
    return device_ms(ctx, "naf.keys")
