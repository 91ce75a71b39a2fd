"""Per-subgraph RSC plan caches (paper §3.3.1, footnote 1).

The port of ``repro.pipeline.plan_pool``. In the GraphSAINT setting the
paper applies the caching mechanism *per sampled subgraph*: subgraph t
keeps its own allocator output and sampling plans across the epochs it
reappears in, refreshed on its own clock from the gradient row norms of its
*own* last visit. This module pools one :class:`PlanCache` per subgraph and
tracks hit/refresh statistics.

Every cache is built with the fixed ``plan_pad`` of its subgraph's shape
bucket, so all plans of a bucket share one SpMM signature (one autotune
decision), never one per subgraph or per allocation.

Device memory and traffic: caches register the HOST mirror of the backward
operand (``HostBlockCOO`` — the PlanCache only reads its static shape
attributes), so a pooled cache holds only its plans' int32 index arrays on
the device, uploaded once per refresh (``build_plan(..., device=)``), not
the subgraph's tiles. A subgraph's last ∇H row norms stay on the device
until its refresh is due, when they are read to the host once.

Left out until their items: ``state_dict`` / ``load_state_dict`` (step-exact
resume, ROADMAP.md Queue 1 item 5) and the error probes and registry
gauges (item 6).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cache import PlanCache
from repro_torch.core.plan import SamplePlan
from repro_torch.pipeline.partition import HostSubgraph, SubgraphPool


@dataclasses.dataclass
class PoolPlanStats:
    hits: int = 0         # steps served straight from a cached plan
    cold: int = 0         # first-visit cache builds
    refreshes: int = 0    # allocator reruns (per-subgraph clock expiry)

    @property
    def lookups(self) -> int:
        return self.hits + self.cold + self.refreshes

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)


class PlanCachePool:
    """One PlanCache per subgraph, with per-subgraph refresh clocks."""

    def __init__(
        self,
        pool: SubgraphPool,
        names: list[str],
        dims: dict[str, int],
        *,
        budget_frac: float,
        step_frac: float = 0.02,
        strategy: str = "greedy",
        refresh_every: int = 10,
        label: str = "",
        device: str | torch.device = "cuda",
    ):
        self.pool = pool
        self.names = list(names)
        self.dims = dims
        self.budget_frac = budget_frac
        self.step_frac = step_frac
        self.strategy = strategy
        self.refresh_every = refresh_every
        self.label = label
        self.device = device
        self.caches: dict[int, PlanCache] = {}
        self.stats = PoolPlanStats()
        self._visits_since_refresh: dict[int, int] = {}
        self._last_norms: dict[int, dict[str, torch.Tensor]] = {}

    # ------------------------------------------------------------------
    def _build(self, sub: HostSubgraph) -> PlanCache:
        plan_pad = self.pool.buckets[sub.bucket_id].plan_pad
        cache = PlanCache(budget_frac=self.budget_frac,
                          step_frac=self.step_frac,
                          strategy=self.strategy,
                          plan_pad=plan_pad,
                          label=(f"{self.label}/sub{sub.sub_id}"
                                 if self.label else f"sub{sub.sub_id}"),
                          device=self.device)
        for n in self.names:
            cache.register(n, sub.prop_t, sub.meta, self.dims[n], sub.fro)
        return cache

    def plans_for(self, sub: HostSubgraph) -> dict[str, SamplePlan]:
        """Plans for one RSC step on ``sub`` — building or refreshing first
        if this subgraph's clock says so."""
        sid = sub.sub_id
        cache = self.caches.get(sid)
        if cache is None:
            cache = self._build(sub)
            self.caches[sid] = cache
            self._visits_since_refresh[sid] = 0
            self.stats.cold += 1
        elif sid in self._last_norms and (
                # Bootstrap: plans start exact (no gradient info at build),
                # so run the allocator on the FIRST revisit — a subgraph only
                # reappears ~#epochs times, far fewer than full-batch steps,
                # and waiting a full clock would leave most of training
                # un-sampled. After that, the per-subgraph clock rules.
                cache.stats.refreshes == 0
                or self._visits_since_refresh[sid] >= self.refresh_every):
            cache.refresh({k: v.cpu().numpy()
                           for k, v in self._last_norms[sid].items()})
            self._visits_since_refresh[sid] = 0
            self.stats.refreshes += 1
        else:
            self.stats.hits += 1
        self._visits_since_refresh[sid] += 1
        return cache.plans()

    def record_norms(self, sub_id: int,
                     norms: dict[str, torch.Tensor]) -> None:
        """Keep the ∇H row norms of this subgraph's latest step (on their
        device); the next clock expiry refreshes from them."""
        self._last_norms[sub_id] = dict(norms)

    # ------------------------------------------------------------------
    def flops_fraction(self) -> float:
        """Pool-wide achieved backward-SpMM FLOPs vs exact.

        The denominator counts REAL tiles (from the un-padded planner meta),
        not the bucket-padded ``at.s_total`` — otherwise zero pad tiles would
        bias the fraction below 1 even with exact plans.
        """
        caches = self.caches.values()
        if not caches:
            return 1.0
        num = sum(e.plan.n_active * e.d
                  for c in caches for e in c.ops.values())
        den = sum(e.meta.row_ids.shape[0] * e.d
                  for c in caches for e in c.ops.values())
        return num / max(den, 1)

    def host_seconds(self) -> float:
        return sum(c.stats.host_seconds for c in self.caches.values())

    def summary(self) -> dict:
        """JSON-ready plan-cache statistics of the pool."""
        return {
            "label": self.label,
            "subgraphs": sorted(self.caches.keys()),
            "hits": self.stats.hits,
            "cold": self.stats.cold,
            "refreshes": self.stats.refreshes,
            "hit_rate": round(self.stats.hit_rate, 4),
            "flops_fraction": round(self.flops_fraction(), 4),
            "host_seconds": round(self.host_seconds(), 4),
            "caches": [{"label": c.label, **c.stats.summary()}
                       for c in self.caches.values()],
        }
