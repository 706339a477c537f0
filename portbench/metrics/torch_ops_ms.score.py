"""Device milliseconds a step in operations that are not the port's hand
kernels (the models' plain torch operations, the store's gather, copies),
from the profiled passes of the traced run."""

MOVES = "score_graphs_per_s"


def read(ctx):
    if ctx.mode != "score":
        return None
    p = ctx.rec["profile"]
    return 1e3 * p["family_s"].get("torch", 0.0) / p["steps"]
