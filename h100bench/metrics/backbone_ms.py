"""Device time per step of the kernels launched under the program's
``naf.backbone`` range (the teacher's two forwards), in ms."""

RANGE = "naf.backbone"


def read(ctx):
    us = ctx.trace.ranges_us.get(RANGE)
    if not us:
        return None
    return us * 1e-3 / ctx.calls
