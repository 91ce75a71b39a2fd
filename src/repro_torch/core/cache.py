"""Plan cache (paper §3.3.1): sample every R steps, reuse in between.

The port of ``repro.core.cache``. The cache owns, per backward sparse op
(= per layer):

* the host BlockMeta of the Ãᵀ operand,
* the most recent SamplePlan (its arrays on the cache's device),
* refresh logic: rerun allocator (Alg. 1) + rebuild plans every R steps
  from the latest ∇H row norms the training step reported.

A refresh is O(S) int32 host work plus one upload of each op's plan; the
tiles never move.

``s_pad`` bucketing: plan lengths quantize to multiples of
``ceil(s_total · BUCKET_FRAC)``, as in the reference (there it bounds
recompiles; here it keeps the plans bit-identical to the reference's).
A cache built with ``plan_pad`` (the minibatch pools' per-bucket length)
pads every plan, full and sampled, to exactly ``plan_pad`` entries, so all
plans of a shape bucket share one SpMM signature (one autotune decision).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.allocator import (Allocation, LayerSpec,
                                        greedy_allocate, uniform_allocate)
from repro_torch.core.plan import SamplePlan, build_plan, full_plan
from repro_torch.core.sampling import block_scores, topk_overlap_auc
from repro_torch.sparse.bcoo import BlockCOO, BlockMeta

BUCKET_FRAC = 1 / 16


def host_norms(norms: dict) -> dict[str, np.ndarray]:
    """∇H row norms as host arrays (tensors on any device, or arrays): what
    ``PlanCache.refresh`` takes and a checkpoint keeps."""
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in norms.items()}


@dataclasses.dataclass
class OpEntry:
    name: str
    at: BlockCOO            # backward operand Ãᵀ (only its shapes are read)
    meta: BlockMeta         # host planner metadata of Ãᵀ
    d: int                  # hidden dim of this op's dense operand
    a_fro: float            # ‖Ã‖_F (Eq. 4a denominator, static half)
    plan: SamplePlan | None = None
    last_scores: np.ndarray | None = None


@dataclasses.dataclass
class CacheStats:
    refreshes: int = 0
    allocations: int = 0
    host_seconds: float = 0.0
    k_history: list = dataclasses.field(default_factory=list)
    auc_history: list = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        """JSON-ready snapshot (per-cache reporting)."""
        return {
            "refreshes": self.refreshes,
            "allocations": self.allocations,
            "host_seconds": round(self.host_seconds, 4),
            "mean_auc": (float(np.mean(self.auc_history))
                         if self.auc_history else None),
        }


class PlanCache:
    """Owns sampling plans for every RSC op in a model."""

    def __init__(
        self,
        budget_frac: float,
        step_frac: float = 0.02,
        strategy: str = "greedy",   # or "uniform" (Fig. 6 baseline)
        *,
        plan_pad: int | None = None,
        label: str = "",            # diagnostics: which subgraph
        device: str | torch.device = "cuda",
    ):
        self.budget_frac = budget_frac
        self.step_frac = step_frac
        self.strategy = strategy
        self.plan_pad = plan_pad
        self.label = label
        self.device = device
        self.ops: dict[str, OpEntry] = {}
        self.stats = CacheStats()

    def _bucket(self, at) -> int:
        if self.plan_pad is not None:
            return self.plan_pad
        return max(1, int(np.ceil(at.s_total * BUCKET_FRAC)))

    def register(self, name: str, at: BlockCOO, meta: BlockMeta, d: int,
                 a_fro: float) -> None:
        """``at`` may be a device BlockCOO or a host mirror — only its
        static shape attributes (and never its tiles) are read here."""
        entry = OpEntry(name=name, at=at, meta=meta, d=d, a_fro=a_fro)
        # Start exact (full plan) until the first refresh has gradient info.
        entry.plan = full_plan(meta, at.n_row_blocks, at.s_total,
                               bucket=self.plan_pad or 1, device=self.device)
        self.ops[name] = entry

    def plans(self) -> dict[str, SamplePlan]:
        return {k: v.plan for k, v in self.ops.items()}

    def refresh(self, grad_row_norms: dict[str, np.ndarray]) -> Allocation:
        """Re-run allocator + rebuild all plans from fresh ∇H row norms.

        grad_row_norms[name]: (n_rows_of_∇H,) — ‖∇H^{(l+1)}_{i,:}‖₂ per node.
        """
        t0 = time.perf_counter()
        names = list(self.ops.keys())
        layers = []
        for n in names:
            e = self.ops[n]
            g = grad_row_norms[n].astype(np.float64)
            scores = block_scores(e.meta.col_norm,
                                  g[: e.meta.col_norm.shape[0]],
                                  e.at.bk, e.at.n_col_blocks)
            gfro = float(np.sqrt(np.sum(g * g)))
            layers.append(LayerSpec(scores=scores,
                                    tiles=e.meta.col_block_tiles,
                                    d=e.d,
                                    norm=e.a_fro * max(gfro, 1e-30)))
        if self.strategy == "greedy":
            alloc = greedy_allocate(layers, self.budget_frac, self.step_frac)
        else:
            alloc = uniform_allocate(layers, self.budget_frac)

        for n, spec, keep in zip(names, layers, alloc.keep):
            e = self.ops[n]
            e.plan = build_plan(e.meta, keep, e.at.n_row_blocks,
                                e.at.s_total, bucket=self._bucket(e.at),
                                device=self.device)
            if e.last_scores is not None:
                self.stats.auc_history.append(
                    topk_overlap_auc(e.last_scores, keep))
            e.last_scores = spec.scores
        self.stats.refreshes += 1
        self.stats.allocations += 1
        self.stats.k_history.append(alloc.k.copy())
        self.stats.host_seconds += time.perf_counter() - t0
        obs.get_ledger().note_allocation(
            scope=self.label or "full", strategy=self.strategy,
            cost=float(alloc.cost), budget=float(alloc.budget),
            k=alloc.k)
        return alloc

    def flops_fraction(self) -> float:
        """Achieved backward-SpMM FLOPs vs exact (diagnostics / Table 2)."""
        num = sum(e.plan.n_active * e.d for e in self.ops.values())
        den = sum(e.at.s_total * e.d for e in self.ops.values())
        return num / max(den, 1)
