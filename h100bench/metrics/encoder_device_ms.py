"""Device time per call of what the encoder launched: the operations under
the program's ``naf.encoder`` span (``ImageEncoder.encode_guarded``: the input
guard, both conv stacks on K1 and their GroupNorm statistics), in ms."""

from h100bench.metrics.program_spans import device_ms


def read(ctx):
    return device_ms(ctx, "naf.encoder")
