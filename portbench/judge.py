"""What decides ``correct``: the program's outputs against the plain reference.

Training (set-up's compared pass: the window's own call from the initial
weights and a cleared Adam state, every step a replay of the captured graph
that the window replays; the reference follows every step of it): ``loss_gap``, the relative gap of the
first step's loss (the engine's own); ``grad_gap``, the worst leaf's gap
between the norms of the first gradient (the program's worked out from
Adam's first moment after one step, ``exp_avg / (1 - beta1)``) and the
reference's; ``change_gap``, the median leaf's gap between the norms of the
weights' change over the pass. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone (the dead attention
weights of quirk Q1 get none) and are left out of both; a counted leaf's gap
is measured against the reference's norm of that leaf or of the median
counted leaf, whichever is larger. The later steps' losses and the worst
leaf's change are logged, not compared: from the second Adam step on, the
trajectory amplifies round-off by orders of magnitude on some seeds (PERF.md
§2), so they would fail sound runs and separate no control.

Scoring: ``pred_gap``, the widest gap of a score over every pass of the
window, relative to the root mean square of the reference's scores.

A number is held to its limit in ``limits/<cell>.json``: at or under it.
"""

from __future__ import annotations

import numpy as np

from portbench import reference

DEAD_LEAF = 1e-3


def _norms(tree: dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(v, dtype=np.float64))) for k, v in tree.items()}


def leaf_gaps(got: dict, want: dict, live: set) -> dict:
    """Each counted leaf's gap of norms over the larger of its reference
    norm and the median counted leaf's."""
    g, w = _norms(got), _norms(want)
    med = float(np.median([w[k] for k in live]))
    return {k: abs(g[k] - w[k]) / max(w[k], med) for k in sorted(live)}


def live_leaves(first_grad: dict) -> set:
    norms = _norms(first_grad)
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n >= DEAD_LEAF * med}


def train_numbers(got: dict, ref: dict, weights0: dict) -> dict:
    """``got`` and ``ref``: ``losses`` per step, ``first_grad`` and
    ``weights`` (after the pass) per leaf, as numpy or CPU tensors."""
    live = live_leaves(ref["first_grad"])
    w0 = {k: np.asarray(v, dtype=np.float64) for k, v in weights0.items()}
    change = lambda w: {k: np.asarray(w[k], dtype=np.float64) - w0[k] for k in w0}  # noqa: E731
    lg, lr = np.asarray(got["losses"], np.float64), np.asarray(ref["losses"], np.float64)
    if lg.shape != lr.shape:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "change_gap": float("inf")}
    return {
        "loss_gap": float(abs(lg[0] - lr[0]) / abs(lr[0])),
        "grad_gap": max(leaf_gaps(got["first_grad"], ref["first_grad"], live).values()),
        "change_gap": float(np.median(list(leaf_gaps(change(got["weights"]),
                                                     change(ref["weights"]), live).values()))),
    }


def score_numbers(passes: np.ndarray, ref: np.ndarray) -> dict:
    """``passes [P, N]``: every pass's scores in the reference's order."""
    if passes.ndim != 2 or passes.shape[1] != ref.shape[0] or not np.isfinite(passes).all():
        return {"pred_gap": float("inf")}
    rms = float(np.sqrt(np.mean(ref ** 2)))
    return {"pred_gap": float(np.max(np.abs(passes - ref[None])) / rms)}


def reference_train(cell, graphs: list, weights0: dict, first: dict, seed: int, device,
                    tf32: bool = False, fault: str = None) -> dict:
    """The reference's steps over the batches of the program's compared pass
    (``first``: its ``mols`` a step, and the ``masks_before`` it the engine
    drew), with the dropout masks the engine draws from ``seed``; ``tf32``
    and ``fault`` make it a control (``reference.train``)."""
    model = cell.config["model"]
    by_mol = {g["mol"]: g for g in graphs}
    batches = [[by_mol[m] for m in mols] for mols in first["mols"]]
    masks = reference.dropout_masks(seed, first["masks_before"], len(batches), cell.mix["batch"],
                                    cell.net.dropout_width(model), model["dropout"], device)
    return reference.train(cell.net, model, weights0, batches, masks, device, tf32, fault)


def reference_scores(cell, graphs: list, weights0: dict, mols: list, device,
                     tf32: bool = False, fault: str = None) -> np.ndarray:
    by_mol = {g["mol"]: g for g in graphs}
    return reference.predict(cell.net, cell.config["model"], weights0,
                             [by_mol[m] for m in mols], device, cell.mix["batch"], tf32, fault)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, the checks as ``{name: {"value", "limit"}}``)."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return bool(ok), checks
