"""The share of the traced window in which no kernel, memcpy or memset ran
on the device: 100 (1 - busy / window)."""


def read(ctx):
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
