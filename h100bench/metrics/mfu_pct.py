"""The whole call's (or step's) share of the card's bf16 peak: the
algorithm's FLOPs per call (h100bench.work) over the traced window's wall
time per call times the peak."""

from h100bench.work import peaks


def read(ctx):
    flops = ctx.work.get("flops")
    if not flops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * flops * ctx.calls / (ctx.trace.window_s * peaks(ctx.card)[1])
