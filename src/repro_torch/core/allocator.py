"""Layer-wise FLOPs allocation (paper §3.2, Eq. 4, Algorithm 1).

Greedy: start with every layer keeping everything (k_l = n_col_blocks);
each move drops the ``step`` lowest-score kept blocks of the layer whose
Eq. 4a error increment is minimal, until total backward-SpMM cost fits the
budget C · Σ_l cost_full_l (Eq. 4b).

Costs are in tile units (one tile = 2·bm·bk·d_l FLOPs), so the block count
the allocator controls is exactly the number of tiles the backward SpMM
kernel reads — the mechanism restoring the paper's "k controls efficiency"
link for sparse ops.

``uniform_allocate`` is the paper's Fig. 6 baseline; ``dp_allocate`` is an
exact grouped-knapsack reference used by tests to certify greedy quality.

The port of ``repro.core.allocator``: a copy of its numpy, so the same
scores give bit-identical allocations in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Planner view of one backward sparse op (one layer)."""

    scores: np.ndarray   # (n_col_blocks,) Eq. 4a values ‖Ã_{:,b}‖‖∇H_b‖ (unnormalized)
    tiles: np.ndarray    # (n_col_blocks,) tiles per column block (cost units)
    d: int               # hidden dim d_l (scales cost per Eq. 4b)
    norm: float          # ‖Ã‖_F · ‖∇H^{(l+1)}‖_F — Eq. 4a denominator


@dataclasses.dataclass(frozen=True)
class Allocation:
    keep: list[np.ndarray]   # per layer bool (n_col_blocks,)
    k: np.ndarray            # per layer #kept column blocks
    cost: float              # achieved Σ tiles·d
    budget: float            # C · Σ full tiles·d
    error: float             # Eq. 4a objective value (sum of dropped mass)
    # Per-layer achieved cost (tiles·d), summing to ``cost`` — the
    # approximation ledger's allocated-resources breakdown.
    layer_cost: np.ndarray | None = None


def _layer_order(spec: LayerSpec) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ascending-score order + prefix sums of (normalized value, cost)."""
    order = np.argsort(spec.scores, kind="stable")
    v = spec.scores[order].astype(np.float64) / max(spec.norm, 1e-30)
    c = spec.tiles[order].astype(np.float64) * spec.d
    return order, np.concatenate([[0.0], np.cumsum(v)]), \
        np.concatenate([[0.0], np.cumsum(c)])


def greedy_allocate(
    layers: list[LayerSpec],
    budget_frac: float,
    step_frac: float = 0.02,
    cost_aware: bool = False,
) -> Allocation:
    """Algorithm 1 at block granularity.

    ``cost_aware=False`` is the paper's Alg. 1 verbatim: each move drops
    from the layer with the smallest Eq. 4a error INCREMENT. That criterion
    is cost-blind — it can drain a cheap low-error layer while an expensive
    one would have freed the same budget in one move. ``cost_aware=True``
    (beyond-paper) ranks moves by error-increment per unit cost freed,
    which the DP certificate shows closes most of the optimality gap at
    identical runtime.
    """
    L = len(layers)
    total_full = sum(float(np.sum(sp.tiles)) * sp.d for sp in layers)
    budget = budget_frac * total_full

    orders, pv, pc = zip(*(_layer_order(sp) for sp in layers))
    n_cb = [sp.scores.shape[0] for sp in layers]
    step = [max(1, int(round(step_frac * n))) for n in n_cb]
    dropped = [0] * L                       # blocks dropped so far per layer
    cost = total_full
    error = 0.0

    while cost > budget:
        best, best_key, best_inc, best_new = -1, np.inf, np.inf, 0
        for l in range(L):
            new = min(dropped[l] + step[l], n_cb[l])
            if new == dropped[l]:
                continue  # layer exhausted
            inc = pv[l][new] - pv[l][dropped[l]]
            dc = pc[l][new] - pc[l][dropped[l]]
            key = inc / max(dc, 1e-12) if cost_aware else inc
            if key < best_key:
                best, best_key, best_inc, best_new = l, key, inc, new
        if best < 0:
            break  # nothing left to drop anywhere
        cost -= pc[best][best_new] - pc[best][dropped[best]]
        error += best_inc
        dropped[best] = best_new

    keep, k, lcost = [], [], []
    for l in range(L):
        mask = np.ones(n_cb[l], dtype=bool)
        mask[orders[l][: dropped[l]]] = False
        keep.append(mask)
        k.append(n_cb[l] - dropped[l])
        lcost.append(pc[l][-1] - pc[l][dropped[l]])
    return Allocation(keep=keep, k=np.asarray(k), cost=cost, budget=budget,
                      error=error, layer_cost=np.asarray(lcost))


def uniform_allocate(layers: list[LayerSpec], budget_frac: float) -> Allocation:
    """Paper's Fig. 6 baseline: k_l = C · n_col_blocks for every layer,
    keeping the top-scored blocks (note: cost is NOT guaranteed ≤ budget —
    that is exactly the deficiency RSC's allocator fixes)."""
    keep, k, cost, lcost = [], [], 0.0, []
    for sp in layers:
        n = sp.scores.shape[0]
        kk = max(1, int(round(budget_frac * n)))
        idx = np.argpartition(-sp.scores, min(kk, n) - 1)[:kk]
        mask = np.zeros(n, dtype=bool)
        mask[idx] = True
        keep.append(mask)
        k.append(kk)
        lc = float(np.sum(sp.tiles[mask])) * sp.d
        lcost.append(lc)
        cost += lc
    total_full = sum(float(np.sum(sp.tiles)) * sp.d for sp in layers)
    err = sum(float(np.sum(sp.scores[~m])) / max(sp.norm, 1e-30)
              for sp, m in zip(layers, keep))
    return Allocation(keep=keep, k=np.asarray(k), cost=cost,
                      budget=budget_frac * total_full, error=err,
                      layer_cost=np.asarray(lcost))


def dp_allocate(
    layers: list[LayerSpec],
    budget_frac: float,
    step_frac: float = 0.02,
) -> Allocation:
    """Exact grouped knapsack over the same (layer, k) grid the greedy walks.

    Exponential-free DP over discretized cost; only for small test instances
    (the paper notes DP is too slow in practice — §3.2.1).
    """
    L = len(layers)
    total_full = sum(float(np.sum(sp.tiles)) * sp.d for sp in layers)
    budget = budget_frac * total_full

    # Per layer enumerate candidate drop counts on the greedy's grid.
    options = []  # (cost_int, value_kept) per layer
    scale = max(total_full / 2000.0, 1.0)  # discretize cost to ≤2000 bins
    for sp in layers:
        order, pv, pc = _layer_order(sp)
        n = sp.scores.shape[0]
        step = max(1, int(round(step_frac * n)))
        drops = list(range(0, n + 1, step))
        if drops[-1] != n:
            drops.append(n)
        full_c = pc[-1]
        full_v = pv[-1]
        # ceil keeps DP conservative: discretized cost ≥ true cost/scale,
        # so the DP solution never exceeds the true budget.
        opts = [(int(np.ceil((full_c - pc[d]) / scale - 1e-12)),
                 full_v - pv[d], d) for d in drops]
        options.append(opts)

    cap = int(round(budget / scale))
    NEG = -1e18
    dp = np.full(cap + 1, NEG)
    dp[0] = 0.0
    choice = np.zeros((L, cap + 1), dtype=np.int64)
    for l, opts in enumerate(options):
        ndp = np.full(cap + 1, NEG)
        nch = np.zeros(cap + 1, dtype=np.int64)
        for ci, vi, d in opts:
            if ci > cap:
                continue
            cand = dp[: cap + 1 - ci] + vi
            seg = ndp[ci:]
            better = cand > seg
            ndp[ci:] = np.where(better, cand, seg)
            nch[ci:][better] = d
        dp, choice[l] = ndp, nch
    best_c = int(np.argmax(dp))
    # Backtrack.
    drops = [0] * L
    c = best_c
    for l in range(L - 1, -1, -1):
        d = int(choice[l][c])
        drops[l] = d
        order, pv, pc = _layer_order(layers[l])
        ci = int(np.ceil((pc[-1] - pc[d]) / scale - 1e-12))
        c -= ci
        c = max(c, 0)
    keep, k, cost, err, lcost = [], [], 0.0, 0.0, []
    for l, sp in enumerate(layers):
        order, pv, pc = _layer_order(sp)
        mask = np.ones(sp.scores.shape[0], dtype=bool)
        mask[order[: drops[l]]] = False
        keep.append(mask)
        k.append(sp.scores.shape[0] - drops[l])
        lc = float(np.sum(sp.tiles[mask])) * sp.d
        lcost.append(lc)
        cost += lc
        err += pv[drops[l]]
    return Allocation(keep=keep, k=np.asarray(k), cost=cost, budget=budget,
                      error=err, layer_cost=np.asarray(lcost))
