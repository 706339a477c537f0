"""Run one cell of the port's benchmark once, and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic, limits and
metrics are found by the names in ``BENCHMARK.json`` (``portbench/spec.py``).
``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` times a stretch of the same length with the
profiler off, then profiles a few passes, and reports the per-layer metrics.
Both decide ``correct`` by the output check (``portbench/judge.py``). The
last line of standard output is the result, one JSON object; every other
line names the cards. Without as many CUDA cards as the cell asks for, the
run exits 3 and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if __name__ == "__main__":
    # the script's folder would shadow modules by its files' names
    sys.path = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(ROOT))

# fixed cache directories inside the checkout: only a cell's first run there
# builds the hand kernels; no library the port uses may load JAX
BUILD = HERE / "_build"
os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import numpy as np  # noqa: E402

from portbench import judge, spec  # noqa: E402

KERNELS = BUILD / "kernels"
EXIT_NO_CARDS = 3
EXIT_FORBIDDEN = 4


def e2e_metrics(cell, rec: dict) -> dict:
    """The cell's end-to-end metrics from the run's record."""
    w = rec["window"]
    values = {
        "setup_s": rec["setup"]["setup_s"],
        "train_graphs_per_s": len(w["pass_s"]) * cell.mix["graphs"] / w["elapsed_s"],
        "score_graphs_per_s": len(w["pass_s"]) * cell.mix["graphs"] / w["elapsed_s"],
        "score_pass_p95_ms": 1e3 * float(np.percentile(w["pass_s"], 95)),
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def layer_metrics(cell, rec: dict, shared: dict) -> dict:
    ctx = spec.Ctx(cell.mix["mode"], rec, shared)
    out = {}
    for m in cell.per_layer:
        v = spec.load_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


class Tagged:
    """A text stream that heads each line written to ``stream`` with
    ``tag`` (the cards' names, count and power limits)."""

    def __init__(self, stream, tag: str):
        self.stream, self.tag, self.part = stream, tag, ""

    def write(self, text: str) -> int:
        lines = (self.part + text).split("\n")
        self.part = lines.pop()
        for line in lines:
            self.stream.write(f"{self.tag} {line}\n")
        return len(text)

    def flush(self) -> None:
        self.stream.flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return "; ".join(line.strip() for line in res.stdout.splitlines() if line.strip())
    except (OSError, subprocess.SubprocessError) as err:
        return f"power limit not read ({err})"


def collect(cell, seed: int, seconds: float, trace: bool, device: str, tmp: str, log=print,
            dense_fast: bool = False) -> tuple:
    """Set-up and window on ``device`` ("cuda", or "cpu" in the harness's
    own tests): the run's record, its graphs and its initial weights.
    ``dense_fast`` serves the controls."""
    from portbench import cell as cell_mod

    if cell.chips != 1:
        raise RuntimeError(f"{cell.name} asks for {cell.chips} cards; the harness runs one "
                           f"process on one card")
    rec = cell_mod.session(cell, seed, seconds, trace, device, os.path.join(tmp, "engine"),
                           str(KERNELS), T_START, dense_fast=dense_fast)
    graphs, weights = rec.pop("graphs"), rec.pop("weights")
    log(f"set-up {rec['setup']}, peak {rec['memory_peak_bytes']} B, graphs {rec['graph_stats']}")
    w = rec.get("window") or rec["stretch"]
    ms = 1e3 * np.asarray(w["pass_s"])
    third = max(1, len(ms) // 3)
    log(f"window {w['elapsed_s']:.3f} s, {len(ms)} passes; a pass's ms: median "
        f"{np.median(ms):.4f}, p5 {np.percentile(ms, 5):.4f}, p95 {np.percentile(ms, 95):.4f}, "
        f"max {ms.max():.4f}; median of the first third {np.median(ms[:third]):.4f}, of the "
        f"last {np.median(ms[-third:]):.4f}; issue ms a pass {1e3 * np.median(w['issue_s']):.4f}")
    return rec, graphs, weights


def numbers_of(cell, rec: dict, graphs: list, weights: dict, seed: int, device,
               stand_in: dict = None, log=print) -> dict:
    """The numbers the output check compares: the program's outputs against
    the float64 reference, or the reference's own with ``stand_in``
    (``{"tf32": True}`` or ``{"fault": name}``, ``judge.reference_*``) put
    in the program's place, on the batches the program ran."""
    from portbench import cell as cell_mod

    first = rec["first"]
    if cell.training:
        pseed = cell_mod.program_seed(seed)
        ref = judge.reference_train(cell, graphs, weights, first, pseed, device)
        got = (judge.reference_train(cell, graphs, weights, first, pseed, device, **stand_in)
               if stand_in else first)
        w0 = {k: v.double().cpu() for k, v in weights.items()}
        live = judge.live_leaves(ref["first_grad"])
        log(f"{'program' if not stand_in else stand_in}: compared pass of {first['replayed']} "
            f"replays after {first['masks_before']} steps; losses {list(got['losses'])}, "
            f"reference {ref['losses']}; by leaf, first gradient "
            f"{judge.leaf_gaps(got['first_grad'], ref['first_grad'], live)}; change "
            f"{judge.leaf_gaps({k: got['weights'][k] - w0[k] for k in w0}, {k: ref['weights'][k] - w0[k] for k in w0}, live)}")
        return judge.train_numbers(got, ref, w0)
    ref = judge.reference_scores(cell, graphs, weights, first["mols"], device)
    if stand_in:
        got = judge.reference_scores(cell, graphs, weights, first["mols"], device, **stand_in)
        return judge.score_numbers(got[None], ref)
    key = "window" if "window" in rec else "stretch"
    return judge.score_numbers(np.asarray(rec[key]["outputs"], np.float64), ref)


def execute(cell, seed: int, seconds: float, trace: bool, device: str, tmp: str,
            log=print) -> dict:
    """A whole run: :func:`collect`, the output check, the metrics; returns
    the result's fields."""
    from portbench import cell as cell_mod

    rec, graphs, weights = collect(cell, seed, seconds, trace, device, tmp, log)
    correct, checks = judge.verdict(
        numbers_of(cell, rec, graphs, weights, seed, device, log=log), cell.limits)
    res = {"correct": correct}
    if trace:
        from portbench import roofline

        shared = cell_mod.work_per_step(cell, graphs)
        shared["fp32_peak_flops"] = roofline.FP32_FLOPS
        p, st = rec["profile"], rec["stretch"]
        log(f"profiled {p['steps']} steps: K3 launches traced {p['k3_launches']}, counted "
            f"{p['k3_launches_counted']}; device seconds by family {p['family_s']}; busy "
            f"{p['busy_s']:.6f} s over {p['window_s']:.6f} s; a pass's wall {st['pass_wall_s']:.6f} "
            f"s unprofiled, {p['window_s'] / p['passes']:.6f} s profiled (the profiler's slowdown "
            f"{p['window_s'] / p['passes'] / st['pass_wall_s']:.4f}x); a step's work {shared}")
        res["metrics"] = layer_metrics(cell, rec, shared)
        res["device_extra"] = {"busy_s": p["busy_s"], "window_s": p["window_s"]}
        res["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
        passes = len(st["pass_s"]) + p["passes"]
    else:
        res["metrics"] = e2e_metrics(cell, rec)
        passes = len(rec["window"]["pass_s"])
    res["attempted"] = passes * rec["steps_per_pass"] if cell.training else passes
    res["failed"] = 0
    res["memory_peak_bytes"] = rec["memory_peak_bytes"]
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARDS
    # the card's name and power limit from nvidia-smi, on every line
    tag = f"[{power_limit()} x{cell.chips}]"
    out = sys.stdout
    sys.stdout, sys.stderr = Tagged(sys.stdout, tag), Tagged(sys.stderr, tag)
    print(f"{cell.name} seed {args.seed} seconds {args.seconds} trace {args.trace}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; FP32 peak 67 TFLOP/s, HBM 3.35 TB/s",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        res = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = spec.forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return EXIT_FORBIDDEN
    kind = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"], **res.get("device_extra", {})}
    result = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
              "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        result["breakdown"] = res["breakdown"]
    result["checks"] = res["checks"]
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    out.write(json.dumps(result) + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
