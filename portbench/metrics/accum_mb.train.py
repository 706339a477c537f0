"""MB a training step that index accumulation sums: the elements
``ops/lanes.py`` ``index_add_rows`` accumulated in a pass (the program's
counter ``ACCUMULATED``, counted from shapes at each eager call and at each
replay of a captured step, carried by the engine's ``pass`` span as its
count ``accumulated``) at 4 B an element (float32), over the pass's steps,
averaged over the traced run's unprofiled stretch (the newest passes
recorded without a profiler, as many as the stretch ran). None in a
program whose ``pass`` span carries no such count."""

import sys

MOVES = "train_graphs_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    # the program's spans, as the run loaded it (the harness loads the
    # program only where it runs it); none in a program without them
    trace = sys.modules.get("deeprank_gnn_tpu_torch.trace")
    if trace is None:
        return None
    n = len(ctx.rec["stretch"]["pass_s"])
    passes = [p.span.counts for p in trace.passes() if not p.profiled][-n:]
    if not passes or any("accumulated" not in c for c in passes):
        return None
    return 4 * sum(c["accumulated"] for c in passes) / sum(c["steps"] for c in passes) / 1e6
