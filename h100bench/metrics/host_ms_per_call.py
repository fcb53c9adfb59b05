"""Host time of one call of the entry (a training step in the training
cell): from the call until it returns, before the wait for the device, as a
mean over the traced calls. The harness's own span around the entry."""


def read(ctx):
    if not ctx.host_s:
        return None
    return 1e3 * sum(ctx.host_s) / ctx.calls
