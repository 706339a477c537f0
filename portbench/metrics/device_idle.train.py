"""Share of a pass's time in which no kernel or copy ran on the device:
1 - the device's busy seconds a pass (the union of the operations'
intervals in the profiled passes' trace, over those passes) over a pass's
wall seconds with the profiler off (the unprofiled stretch's wall over its
passes). The profiled passes' own wall is longer by the profiler's work on
the host, so it would count that work as idle; the run's log gives the
ratio of the two."""

MOVES = "train_graphs_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    p, st = ctx.rec["profile"], ctx.rec["stretch"]
    return 1.0 - (p["busy_s"] / p["passes"]) / st["pass_wall_s"]
