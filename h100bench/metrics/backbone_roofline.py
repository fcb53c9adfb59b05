"""The backbone's share of its roofline: the least time the card could take
for one call's ViT forward (``h100bench.work_vit.vit_work``: max(FLOPs /
bf16 peak, bytes / bandwidth)) over the device time a call of what the
program launched under its ``naf.backbone`` range. The range is named in
``backbone_roofline.kernels/`` (a span, not a kernel: the backbone is many
library kernels). No range or no ViT work: no reading."""

from h100bench.work import bound_s


def read(ctx):
    us = sum(ctx.trace.ranges_us.get(name, 0.0) for name in ctx.patterns("backbone_roofline"))
    if us <= 0 or "vit" not in ctx.work:
        return None
    flops, nbytes = ctx.work["vit"]
    return 100.0 * ctx.calls * bound_s(flops, nbytes, ctx.card) / (us * 1e-6)
