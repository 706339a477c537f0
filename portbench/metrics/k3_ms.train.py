"""Device milliseconds a training step in K3 (``ops/csrc/fused_gin_conv.cu``,
by kernel name in the profiled passes); none where no K3 launch was traced."""

MOVES = "train_graphs_per_s"


def read(ctx):
    p = ctx.rec["profile"]
    if ctx.mode != "train" or not p["k3_launches"]:
        return None
    return 1e3 * p["k3_s"] / p["steps"]
