"""K3 and K4's share of their roofline in a training step: the least time
the card could take for one K3 forward and one K4 backward over the step's
attention (h100bench.work_na.k34_work) over the device time of the kernels
that ``k34_roofline.kernels/`` names (the bf16 forward and backward on
either box route, and K4's reduce pass). Nothing matched: no reading."""

from h100bench.work import bound_s


def read(ctx):
    measured = ctx.trace.kernel_s(ctx.patterns("k34_roofline"))
    if measured <= 0 or "k34" not in ctx.work:
        return None
    flops, nbytes = ctx.work["k34"]
    return 100.0 * ctx.calls * bound_s(flops, nbytes, ctx.card) / measured
