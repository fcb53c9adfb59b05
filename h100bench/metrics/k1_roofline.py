"""K1's share of its roofline: the least time the card could take for the
call's fused encoder layers (max of bytes over bandwidth and FLOPs over the
bf16 peak, h100bench.work.k1_work) over the device time of the kernels that
``k1_roofline.kernels/`` names. Nothing matched: no reading."""

from h100bench.work import bound_s


def read(ctx):
    measured = ctx.trace.kernel_s(ctx.patterns("k1_roofline"))
    if measured <= 0 or "k1" not in ctx.work:
        return None
    flops, nbytes = ctx.work["k1"]
    return 100.0 * ctx.calls * bound_s(flops, nbytes, ctx.card) / measured
