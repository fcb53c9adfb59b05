"""Device time per call of the attention: the operations under the program's
``naf.attention`` spans (K2 and its operand padding and alignment copies),
in ms."""

from h100bench.metrics.program_spans import device_ms


def read(ctx):
    return device_ms(ctx, "naf.attention")
