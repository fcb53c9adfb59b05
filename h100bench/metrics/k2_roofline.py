"""K2's share of its roofline: the least time the card could take for the
call's pool-up + RoPE + windowed attention (h100bench.work.k2_work) over
the device time of the kernels that ``k2_roofline.kernels/`` names.
Nothing matched: no reading."""

from h100bench.work import bound_s


def read(ctx):
    measured = ctx.trace.kernel_s(ctx.patterns("k2_roofline"))
    if measured <= 0 or "k2" not in ctx.work:
        return None
    flops, nbytes = ctx.work["k2"]
    return 100.0 * ctx.calls * bound_s(flops, nbytes, ctx.card) / measured
