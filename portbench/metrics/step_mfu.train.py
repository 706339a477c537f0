"""The whole step's share of the card's float32 peak: the FLOPs the
configuration's net needs for a step (``nets/<net>.py`` ``work``, the same
whatever computes them) over the step's time (the unprofiled stretch's wall
time over its steps) and the card's peak."""

MOVES = "train_graphs_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    step_s = ctx.rec["stretch"]["step_s"]
    return 100.0 * ctx.shared["flops_per_step"] / (step_s * ctx.shared["fp32_peak_flops"])
