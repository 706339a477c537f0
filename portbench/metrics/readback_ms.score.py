"""Host milliseconds a pass spent reading a scanned scoring pass's losses and
predictions back: the engine's span ``pass.readback``
(``train/neuralnet.py``), which waits for the device to finish the pass's
steps, averaged over the traced run's unprofiled stretch (the newest passes
recorded without a profiler, as many as the stretch ran)."""

import sys

MOVES = "score_graphs_per_s"


def read(ctx):
    if ctx.mode != "score":
        return None
    # the program's spans, as the run loaded it (the harness loads the
    # program only where it runs it); none in a program without them
    trace = sys.modules.get("deeprank_gnn_tpu_torch.trace")
    if trace is None:
        return None
    n = len(ctx.rec["stretch"]["pass_s"])
    passes = [p for p in trace.passes() if not p.profiled][-n:]
    if not passes:
        return None
    return sum(p.ns("pass.readback") for p in passes) / len(passes) / 1e6
