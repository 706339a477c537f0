"""Host seconds building the pooling plans in set-up (``data/batch.py``
``make_graph_plan`` through the loader, every graph once), timed by the
benchmark around the loader's calls."""

MOVES = "setup_s"


def read(ctx):
    return ctx.rec["setup"]["plans_s"]
