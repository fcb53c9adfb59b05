"""Device time per call of the backbone's FFNs: the operations under the
program's ``naf.backbone.mlp`` spans (each block's SwiGLU or MLP: its three
or two projections and the activation), in ms."""

from h100bench.metrics.program_spans import device_ms


def read(ctx):
    return device_ms(ctx, "naf.backbone.mlp")
