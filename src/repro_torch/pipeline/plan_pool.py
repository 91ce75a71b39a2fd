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

``state_dict`` / ``load_state_dict`` carry the per-subgraph clocks and the
norms each cache's current plans were refreshed from: the allocator is a
pure function of them, so replaying them rebuilds bit-identical plans
(step-exact resume). ``publish`` and the ``plan_pool.*`` counters and
``plan_pool.refresh_ms`` timer feed the metrics registry; ``probe_entries``
hands the most recently served subgraph to the error probes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cache import PlanCache, host_norms
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
        self._last_sid: int | None = None   # most recently served subgraph
        self._visits_since_refresh: dict[int, int] = {}
        self._last_norms: dict[int, dict[str, torch.Tensor]] = {}
        # norms each cache's current plans were refreshed from (None while
        # still on the exact bootstrap plans)
        self._refresh_norms: dict[int, dict[str, np.ndarray] | None] = {}

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
        reg = obs.get_registry()
        pool_label = self.label or "pool"
        cache = self.caches.get(sid)
        if cache is None:
            cache = self._build(sub)
            self.caches[sid] = cache
            self._visits_since_refresh[sid] = 0
            self.stats.cold += 1
            reg.counter("plan_pool.cold", pool=pool_label)
        elif sid in self._last_norms and (
                # Bootstrap: plans start exact (no gradient info at build),
                # so run the allocator on the FIRST revisit — a subgraph only
                # reappears ~#epochs times, far fewer than full-batch steps,
                # and waiting a full clock would leave most of training
                # un-sampled. After that, the per-subgraph clock rules.
                cache.stats.refreshes == 0
                or self._visits_since_refresh[sid] >= self.refresh_every):
            norms = host_norms(self._last_norms[sid])
            with reg.timer("plan_pool.refresh_ms", pool=pool_label):
                cache.refresh(norms)
            self._refresh_norms[sid] = norms
            self._visits_since_refresh[sid] = 0
            self.stats.refreshes += 1
            reg.counter("plan_pool.refreshes", pool=pool_label)
            obs.get_tracer().instant("plan_refresh", pool=pool_label,
                                     sub=int(sid))
        else:
            self.stats.hits += 1
            reg.counter("plan_pool.hits", pool=pool_label)
        self._visits_since_refresh[sid] += 1
        self._last_sid = sid
        return cache.plans()

    def probe_entries(self):
        """(name, at, meta, plan, d) of the most recently served subgraph:
        the error probes sample the pool where training just was (host
        operands, so the probes read no tile from the card)."""
        cache = self.caches.get(self._last_sid)
        if cache is None:
            return []
        return [(n, e.at, e.meta, e.plan, e.d)
                for n, e in cache.ops.items()]

    def record_norms(self, sub_id: int,
                     norms: dict[str, torch.Tensor]) -> None:
        """Keep the ∇H row norms of this subgraph's latest step (on their
        device); the next clock expiry refreshes from them."""
        self._last_norms[sub_id] = dict(norms)

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Per-subgraph clocks + the norms behind the current plans (host
        arrays; reading the last step's norms syncs with the card once)."""
        return {
            int(sid): {
                "visits": self._visits_since_refresh.get(sid, 0),
                "refreshes": self.caches[sid].stats.refreshes,
                "refresh_norms": self._refresh_norms.get(sid),
                "last_norms": (host_norms(self._last_norms[sid])
                               if sid in self._last_norms else None),
            }
            for sid in self.caches
        }

    def load_state_dict(self, state: dict | None) -> None:
        """Rebuild each saved subgraph's cache by replaying its refresh
        norms (bit-identical plans) and restore its clock."""
        if not state:
            return
        by_id = {s.sub_id: s for s in self.pool.subgraphs}
        for sid, st in state.items():
            sid = int(sid)
            cache = self._build(by_id[sid])
            if st.get("refresh_norms") is not None:
                cache.refresh(st["refresh_norms"])
                self._refresh_norms[sid] = st["refresh_norms"]
            cache.stats.refreshes = st.get("refreshes",
                                           cache.stats.refreshes)
            self.caches[sid] = cache
            self._visits_since_refresh[sid] = st.get("visits", 0)
            if st.get("last_norms") is not None:
                self._last_norms[sid] = st["last_norms"]

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

    def publish(self, registry) -> None:
        """Epoch-end snapshot of this pool's clock stats → registry
        gauges."""
        pool_label = self.label or "pool"
        registry.gauge("plan_pool.hit_rate", self.stats.hit_rate,
                       pool=pool_label)
        registry.gauge("plan_pool.subgraphs", len(self.caches),
                       pool=pool_label)
        registry.gauge("plan_pool.flops_fraction", self.flops_fraction(),
                       pool=pool_label)
        registry.gauge("plan_pool.host_seconds", self.host_seconds(),
                       pool=pool_label)

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
