"""Images per second of the training cell, as img_per_s is taken in the
inference cells: the steps of the whole chunks of the unprofiled window
times the batch, over their time. It stands per layer because the host's
speed, which sets the step, spreads it across runs by more than the largest
bound allowed end to end."""


def read(ctx):
    w = ctx.window
    if not w or not w["seconds"] > 0:
        return None
    return w["images"] / w["seconds"]
