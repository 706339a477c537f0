"""Seconds building the device store in set-up (``data/device_store.py``:
the dense collation with the operators where the mix asks for them, the
packing and the upload), timed by the benchmark around the loader's call up
to a device synchronize."""

MOVES = "setup_s"


def read(ctx):
    return ctx.rec["setup"]["store_build_s"]
