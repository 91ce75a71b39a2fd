"""Online error probes: cheap exact-vs-sampled SpMM comparison.

The port of ``repro.obs.probe``: the same draws and the same float64
arithmetic, so the same tiles, meta, plan and seed give the reference's
numbers exactly. The tiles may be a host array (pooled operands) or a
tensor on the card (the full graph): only the probed rows' tiles are
gathered, on the tiles' device, and copied to the host; the plan's index
arrays are read back once.

A probe answers "what relative error is this layer's sampling plan
costing RIGHT NOW?" without running the exact SpMM: it picks a small
subset of output row blocks, multiplies just their tiles (exact set from
the planner metadata, sampled set from the live plan) against a seeded
Gaussian probe matrix of small width, and compares per-row-block
Frobenius errors. A percentile bootstrap over the row blocks turns the
point estimate into a confidence interval — which is what the serving
router and the ledger time series actually want.

Pure numpy on the host apart from those gathers; it launches no kernel
and runs at epoch end, outside the timed step loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """One layer's probe: per-row-block errors + bootstrap CI."""

    op: str
    n_rows: int             # row blocks probed
    d: int                  # probe-matrix width
    rel_errors: np.ndarray  # (n_rows,) per-row-block relative error
    mean: float
    ci_lo: float
    ci_hi: float


def bootstrap_ci(values, n_boot: int = 200, alpha: float = 0.05,
                 seed: int = 0, statistic=np.mean) -> tuple[float, float]:
    """Percentile-bootstrap CI of ``statistic`` over ``values``."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        return (float("nan"), float("nan"))
    if v.size == 1:
        return (float(v[0]), float(v[0]))
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, v.size, size=(n_boot, v.size))
    stats = statistic(v[idx], axis=1)
    lo, hi = np.percentile(stats, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return (float(lo), float(hi))


def _host(x) -> np.ndarray:
    """A host array of ``x`` (a numpy array or a tensor on any device)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _take(blocks, idx: np.ndarray) -> np.ndarray:
    """``blocks[idx]`` on the host; a tensor is indexed on its device, so
    only the selected tiles cross to the host."""
    if isinstance(blocks, np.ndarray):
        return blocks[idx]
    return _host(blocks[torch.from_numpy(idx).to(blocks.device)])


def _accumulate(blocks, sel, row_local, cols, hb, n_rows, bm, d):
    """Σ over selected tiles: out[row] += tile @ hb[col]."""
    out = np.zeros((n_rows, bm, d), dtype=np.float64)
    if sel.size:
        tiles = np.asarray(_take(blocks, sel), dtype=np.float64)
        part = np.einsum("sij,sjd->sid", tiles, hb[cols])
        np.add.at(out, row_local, part)
    return out


def probe_plan_error(
    blocks,
    meta,
    plan,
    *,
    bm: int,
    bk: int,
    n_cols: int,
    op: str = "",
    n_rows: int = 8,
    d_probe: int = 8,
    seed: int = 0,
    n_boot: int = 200,
) -> ProbeResult | None:
    """Exact-vs-plan relative error on a random row-block subset.

    ``blocks`` may be a device or host tile array (fancy-indexed once);
    ``meta`` is the op's :class:`~repro.sparse.bcoo.BlockMeta`; ``plan``
    the live :class:`~repro.core.plan.SamplePlan`. Returns ``None`` when
    the operand has no populated row blocks to probe.
    """
    rng = np.random.default_rng(seed)
    all_rows = np.unique(np.asarray(meta.row_ids))
    if all_rows.size == 0:
        return None
    rows = np.sort(rng.choice(all_rows, size=min(n_rows, all_rows.size),
                              replace=False))
    hb = rng.standard_normal((n_cols // bk, bk, d_probe)).astype(np.float64)
    sentinel = int(blocks.shape[0]) - 1   # blocks = (s_total + 1, bm, bk)

    # Exact side: every tile of the probed rows, straight from the
    # planner metadata (which indexes the un-padded tile list).
    e_idx = np.nonzero(np.isin(meta.row_ids, rows))[0].astype(np.int64)
    e_local = np.searchsorted(rows, meta.row_ids[e_idx])
    exact = _accumulate(blocks, e_idx, e_local, meta.col_ids[e_idx], hb,
                        rows.size, bm, d_probe)

    # Sampled side: the plan's kept tiles on the same rows (sentinel
    # entries contribute zero by construction and are skipped).
    p_sel = _host(plan.sel)
    p_rows = _host(plan.row_ids)
    p_cols = _host(plan.col_ids)
    keep = (p_sel != sentinel) & np.isin(p_rows, rows)
    s_idx = p_sel[keep].astype(np.int64)
    s_local = np.searchsorted(rows, p_rows[keep])
    approx = _accumulate(blocks, s_idx, s_local, p_cols[keep], hb,
                         rows.size, bm, d_probe)

    diff = exact - approx
    e_norm = np.sqrt(np.sum(exact * exact, axis=(1, 2)))
    d_norm = np.sqrt(np.sum(diff * diff, axis=(1, 2)))
    rel = d_norm / np.maximum(e_norm, 1e-12)
    lo, hi = bootstrap_ci(rel, n_boot=n_boot, seed=seed)
    return ProbeResult(op=op, n_rows=int(rows.size), d=int(d_probe),
                       rel_errors=rel, mean=float(np.mean(rel)),
                       ci_lo=lo, ci_hi=hi)
