"""Host seconds collating the store's operator fields in set-up: the sum of
the spans ``store.operators`` (``data/dense_batch.py``, one a graph) inside
the newest ``store.build`` (``data/batch.py``), the part of
``store_build_s`` that the precomputed operators cost."""

import sys

MOVES = "setup_s"


def read(ctx):
    # the program's spans, as the run loaded it (the harness loads the
    # program only where it runs it); none in a program without them
    trace = sys.modules.get("deeprank_gnn_tpu_torch.trace")
    if trace is None:
        return None
    builds = trace.trees("store.build")
    if not builds:
        return None
    return builds[-1].ns("store.operators") / 1e9
