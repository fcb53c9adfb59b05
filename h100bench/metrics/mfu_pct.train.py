"""The training step's share of the card's bf16 peak: the algorithm's FLOPs
per step (h100bench.work) times the steps of the unprofiled window, over
that window's wall time times the peak."""

from h100bench.work import peaks


def read(ctx):
    flops, w = ctx.work.get("flops"), ctx.window
    if not flops or not w or not w["seconds"] > 0:
        return None
    return 100.0 * flops * w["calls"] / (w["seconds"] * peaks(ctx.card)[1])
