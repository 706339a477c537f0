"""Host milliseconds a step spent issuing a scanned training epoch's steps: the
engine's own counter ``EpochSteps.last_issue_s`` (``train/scan.py``) over
the pass's steps, averaged over the passes of the traced run's unprofiled
stretch."""

MOVES = "train_graphs_per_s"


def read(ctx):
    return ctx.rec["stretch"]["issue_ms"] if ctx.mode == "train" else None
