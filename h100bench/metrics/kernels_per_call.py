"""Device operations per call (per step in the training cell): kernels,
memcpys and memsets in the traced window, from the profiler."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.calls
