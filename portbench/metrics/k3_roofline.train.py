"""K3's share of its roofline in training: its least time a step (the
net's ``k3_bound_ms`` over the step's graphs, ``nets/<net>.py``: conv1 and
conv2, forward and backward, each input byte read once and each output byte
written once over 3.35 TB/s) over its device time a step (``k3_ms.train``)."""

MOVES = "train_graphs_per_s"


def read(ctx):
    p = ctx.rec["profile"]
    bound = ctx.shared.get("k3_bound_ms_per_step")
    if ctx.mode != "train" or not p["k3_launches"] or not bound:
        return None
    return 100.0 * bound / (1e3 * p["k3_s"] / p["steps"])
