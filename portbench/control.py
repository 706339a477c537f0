"""Readings for the output check's limits: the program and its controls.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 2 \\
        [--control program|tf32|fast|ref:<fault>] ...

For each seed in turn, in this one process, a run of the cell (set-up and a
window of ``--seconds``) and then, for every ``--control`` named:

- ``program``: the numbers the output check compares, the program against
  the float64 reference (the lower readings);
- ``tf32``: the same numbers for the reference computed in TF32, the
  precision just below the configuration's, put in the program's place;
- ``ref:<fault>``: the reference with a fault of the output check's list
  (``reference.train``, ``reference.predict``) put in the program's place,
  on the batches of the same run;
- ``fast``: the program with its own lower-precision path switched on
  (``NeuralNet(dense_fast=True)``: bf16 operands in K3 and ``adj_conv``),
  from a second run of the cell.

``tf32`` must fail every cell. ``fast`` must fail a cell unless its net
file's ``PROGRAM_CONTROLS`` leaves it out (``spec.controls``), as a net that
reads no paper-mode dense aggregation does: ``fast`` leaves its numbers as
they are.

One JSON line a seed and control. The benchmark's runs (``run.py``) never
run this; it needs the card the cell asks for.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    sys.path = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(here.parent))

from portbench import run, spec  # noqa: E402


def readings(cell, seed: int, seconds: float, controls, device: str, log=print) -> list:
    """The readings of one seed, a dict per control."""
    out = []
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        same_run = [c for c in controls if c != "fast"]
        if same_run:
            rec, graphs, weights = run.collect(cell, seed, seconds, False, device, tmp, log)
            for c in same_run:
                stand_in = (None if c == "program" else {"tf32": True} if c == "tf32"
                            else {"fault": c.split(":", 1)[1]})
                out.append({"control": c, **run.numbers_of(cell, rec, graphs, weights, seed,
                                                            device, stand_in, log)})
            del rec
        if "fast" in controls:
            rec, graphs, weights = run.collect(cell, seed, seconds, False, device, tmp, log,
                                               dense_fast=True)
            out.append({"control": "fast", **run.numbers_of(cell, rec, graphs, weights, seed,
                                                            device, log=log)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [{"cell": cell.name, "seed": seed, **o} for o in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="append",
                    choices=("program", "tf32", "fast", "ref:half_batch", "ref:answer_altered"))
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"control: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return run.EXIT_NO_CARDS
    tag = f"[{run.power_limit()} x{cell.chips}]"
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(cell, seed, args.seconds, args.control or ["program"], "cuda",
                             lambda msg: print(f"{tag} {msg}", flush=True)):
            print(f"{tag} reading {json.dumps(line)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
