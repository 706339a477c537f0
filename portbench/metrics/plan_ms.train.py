"""Host milliseconds a pass spent planning a scanned training epoch: the self
time of the engine's span ``pass.plan`` (``train/neuralnet.py``: the epoch's
slot matrix, the targets, the loss and prediction buffers and the slots'
upload), averaged over the traced run's unprofiled stretch (the newest
passes recorded without a profiler, as many as the stretch ran)."""

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
    passes = [p for p in trace.passes() if not p.profiled][-n:]
    if not passes:
        return None
    return sum(p.ns("pass.plan", own=True) for p in passes) / len(passes) / 1e6
