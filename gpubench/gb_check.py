"""The numbers that decide ``correct``: what the timed path produced
against the plain reference (``gb_reference.follow``), each with a limit
of its own (``limits/<workload>.json``; ``PERF.md`` gives the readings each
limit was set from).

Both sides are dicts as ``gb_reference.follow`` returns them, under the
reference's leaf names; the reference took each followed step from the
program's state at its start.

* ``loss``: the worst followed step's ``|L - L_ref| / |L_ref|``.
* ``grad1``: the median leaf's gap of first-gradient norms, each leaf's
  over the reference's norm of that leaf or of the median leaf, the
  larger. The median, not the worst leaf: a pre-activation within
  rounding of 0 flips its ReLU or batchnorm sign on one side, and the
  leaf it feeds swings by 1e-5 on a few seeds in ten; the worst is kept
  in the run's detail.
* ``change``: the worst followed step's median leaf, by the same gap, for
  the norm of the step's change to each leaf (the worst leaf kept in the
  detail). Leaves whose reference gradient is under a thousandth of the
  median leaf's move under Adam by rounding alone (GraphSAGE's biases that
  feed a batchnorm) and are left out.
* ``grad1_layer``, ``change_layer``: the same gaps, the median taken over
  each layer's leaves (``lin.0.*``, ``bn.0.*``, ...) and the worst layer
  kept. A fault below one SpMM moves the few leaves of its layer and not
  the median of all of them.
* ``logits``: the worst evaluation's largest gap over the real rows, over
  the reference's largest logit there; the reference evaluates the
  parameters the program evaluated, so the number is the evaluation's
  own.
* ``plan``: the followed plan refreshes whose allocation is neither the
  reference's nor a near-tie of it (``gb_reference.judge_plan``), or that
  the program did not make; an exact count, limit 0.
"""
from __future__ import annotations

import numpy as np
import torch

NAMES = ("loss", "grad1", "change", "grad1_layer", "change_layer",
         "logits", "plan")
TINY_GRAD = 1e-3


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """Each leaf's gap of norms over the reference's norm of that leaf or
    of the median leaf, the larger."""
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def layer_of(leaf: str) -> int:
    """``lin.0.w`` -> 0."""
    return int(leaf.split(".")[1])


def worst_layer(gaps: dict) -> float:
    """The largest, over layers, of the median gap of a layer's leaves."""
    by = {}
    for k, v in gaps.items():
        by.setdefault(layer_of(k), []).append(v)
    return max(float(np.median(v)) for v in by.values())


def compare(prog: dict, ref: dict, n_rows: int,
            where: dict | None = None, every_leaf: bool = False) -> dict:
    """The compared numbers (see the module docstring). ``where`` (a dict)
    receives the step and epoch the worst loss and logits were read at,
    and the worst leaf's gaps beside the medians compared; with
    ``every_leaf`` every leaf's gaps too."""
    where = {} if where is None else where
    inf = float("inf")
    if "missing" in ref:
        where["missing_step"] = ref["missing"]
        return dict.fromkeys(NAMES, inf)
    plan = sum(not r["ok"] for r in ref["plans"].values())
    steps = sorted(ref["loss"])
    lr = np.array([ref["loss"][s] for s in steps])
    lp = np.array([prog["loss"].get(s, np.nan) for s in steps])
    rel = np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)
    loss = float(np.max(rel)) if np.all(np.isfinite(rel)) else inf
    where["loss_step"] = int(steps[int(np.nanargmax(rel))]) if np.any(
        np.isfinite(rel)) else None

    leaves = sorted(ref["grad1"])
    if set(prog["grad1"]) != set(leaves):
        return {**dict.fromkeys(NAMES, inf), "loss": loss, "plan": plan}
    g1 = leaf_gaps(prog["grad1"], ref["grad1"], leaves)
    grad1 = float(np.median(list(g1.values())))
    grad1_layer = worst_layer(g1)
    where["grad1_worst_leaf"] = max(g1, key=g1.get)
    where["grad1_worst"] = max(g1.values())
    if every_leaf:
        where["grad1_gaps"], where["change_gaps"] = g1, {}

    med_g = float(np.median([ref["grad1"][k] for k in leaves]))
    moving = [k for k in leaves if ref["grad1"][k] >= TINY_GRAD * med_g]
    change = change_layer = worst = 0.0
    for s, ref_u in ref["update"].items():
        if s not in prog["update"]:
            change = change_layer = inf
            continue
        gaps = leaf_gaps(prog["update"][s], ref_u, moving)
        change = max(change, float(np.median(list(gaps.values()))))
        change_layer = max(change_layer, worst_layer(gaps))
        if every_leaf:
            where["change_gaps"][s] = gaps
        k = max(gaps, key=gaps.get)
        if gaps[k] >= worst:
            worst, where["change_worst_leaf"] = gaps[k], f"{k} at step {s}"
    where["change_worst"] = worst

    logits = 0.0
    for epoch, lr_ in ref["logits"].items():
        lp_ = prog["logits"].get(epoch)
        if lp_ is None or lr_ is None:
            logits = inf
            continue
        a = lp_[:n_rows].float().cpu()
        b = lr_[:n_rows].float().cpu()
        gap = float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))
        gap = gap if np.isfinite(gap) else inf
        if gap >= logits:
            logits, where["logits_epoch"] = gap, epoch
    return {"loss": loss, "grad1": grad1, "change": change,
            "grad1_layer": grad1_layer, "change_layer": change_layer,
            "logits": logits, "plan": plan}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit, in the
    limits' order (a number the cell's limits leave out is not
    compared)."""
    out = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
