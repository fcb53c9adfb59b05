"""Device time per step of the encoder's backward: the operations under the
program's ``naf.encoder.backward`` spans (the plain f32 twin of both conv
stacks, recomputed and differentiated), in ms. A program without the span
reads None."""

from h100bench.metrics.program_spans import device_ms


def read(ctx):
    return device_ms(ctx, "naf.encoder.backward")
