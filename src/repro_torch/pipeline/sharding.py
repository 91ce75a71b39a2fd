"""Sharded subgraph pools: data-parallel minibatch RSC training.

The port of ``repro.pipeline.sharding``. The GraphSAINT / LDG pool is
split into one shard per rank (:func:`shard_pool_ids`, round robin within
each shape bucket); every global step trains one subgraph per rank, all
from the same bucket. Host-side planning stays off the device's path
(§3.3.1): each rank keeps one :class:`PlanCachePool` for its own shard,
with its own refresh clocks, fed only the ∇H row norms of its own steps.

The reference runs one process over a ``("data",)`` mesh and stacks the
step's subgraphs (and their plans) along a leading device axis
(``_stack_host_bcoo``, ``stacked_operands``). With one process per rank
there is nothing to stack: each rank uploads only its own subgraph
through the :class:`Prefetcher` and holds only its own plans, so those two
functions have no counterpart here.

Every rank builds the whole pool from the seed and draws the whole
``epoch_schedule`` from one seeded RNG, taking element ``rank`` of each
step's tuple, so the RNG stream and the bucket grouping are the
reference's on every rank (and a resume re-draws them alike). Evaluation
is the reference's pooled evaluation over the whole pool
(``PooledSource.evaluate``); the engine runs it on rank 0 and broadcasts
``(val, test)``.

:class:`ShardedPlanner`'s statistics (``flops_fraction``, ``hit_rate``,
``stats``, ``per_shard_summary``, ``state_dict``, ``publish``) gather
every shard's and are collectives: every rank calls them at the same
point (the engine does).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import RSCSchedule
from repro_torch.pipeline.minibatch_loop import PooledSource
from repro_torch.pipeline.partition import SubgraphPool
from repro_torch.pipeline.plan_pool import PlanCachePool, PoolPlanStats
from repro_torch.pipeline.prefetch import Prefetcher


def shard_pool_ids(pool: SubgraphPool, n_shards: int) -> list[list[int]]:
    """Round-robin partition of subgraph ids into equal-size shards,
    PER BUCKET: every shard receives the same number of subgraphs from
    each shape bucket, so every step can train one same-bucket subgraph
    per rank."""
    if len(pool) % n_shards != 0:
        raise ValueError(
            f"pool size {len(pool)} not divisible by {n_shards} shards; "
            "choose n_subgraphs as a multiple of the data-parallel degree")
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    for b in range(len(pool.buckets)):
        ids = [s.sub_id for s in pool.subgraphs if s.bucket_id == b]
        if len(ids) % n_shards != 0:
            raise ValueError(
                f"bucket {b} holds {len(ids)} subgraphs, not divisible by "
                f"{n_shards} shards; sharded stacking draws one SAME-bucket "
                "subgraph per device each step, so every bucket must split "
                "evenly (raise n_subgraphs or lower n_buckets)")
        for d in range(n_shards):
            shards[d].extend(ids[d::n_shards])
    return shards


class ShardedPlanner:
    """This rank's shard's :class:`PlanCachePool` (label ``shard{rank}``)
    and the gathered statistics of all shards."""

    def __init__(self, pool: SubgraphPool, shards: list[list[int]],
                 names, dims, *, budget_frac: float, step_frac: float,
                 strategy: str, refresh_every: int, group):
        self.pool = pool
        self.shards = shards
        self.group = group
        self.rank = group.rank
        self.local = PlanCachePool(
            pool, names, dims, budget_frac=budget_frac,
            step_frac=step_frac, strategy=strategy,
            refresh_every=refresh_every, label=f"shard{group.rank}",
            device=group.device)

    def plans_for(self, tag, step: int, schedule: RSCSchedule):
        return self.local.plans_for(self.pool.subgraphs[int(tag[self.rank])])

    def record(self, tag, norms) -> None:
        """This rank's norms only, for its own subgraph of the step."""
        self.local.record_norms(int(tag[self.rank]), norms)

    # ------------------------------------------------- gathered (collective)
    def _gather(self) -> list[dict]:
        p = self.local
        return self.group.gather_objects({
            "stats": PoolPlanStats(**vars(p.stats)),
            "flops_fraction": p.flops_fraction(),
            "host_seconds": p.host_seconds(),
            "subgraphs": len(p.caches),
            "summary": p.summary()})

    def flops_fraction(self) -> float:
        fracs = [s["flops_fraction"] for s in self._gather()]
        return float(np.mean(fracs)) if fracs else 1.0

    @staticmethod
    def _hit_rate(shards: list[dict]) -> float:
        hits = sum(s["stats"].hits for s in shards)
        lookups = sum(s["stats"].lookups for s in shards)
        return hits / max(lookups, 1)

    def hit_rate(self) -> float | None:
        return self._hit_rate(self._gather())

    def stats(self) -> list[PoolPlanStats]:
        return [s["stats"] for s in self._gather()]

    def k_latest(self):
        return None

    def publish(self, registry) -> None:
        """Per-shard plan-cache stats → registry (labelled shard0..N-1),
        and the pool-wide aggregates the result JSON reports."""
        shards = self._gather()
        for d, s in enumerate(shards):
            label = f"shard{d}"
            registry.gauge("plan_pool.hit_rate", s["stats"].hit_rate,
                           pool=label)
            registry.gauge("plan_pool.subgraphs", s["subgraphs"], pool=label)
            registry.gauge("plan_pool.flops_fraction", s["flops_fraction"],
                           pool=label)
            registry.gauge("plan_pool.host_seconds", s["host_seconds"],
                           pool=label)
        registry.gauge("plan_pool.hit_rate", self._hit_rate(shards),
                       pool="all_shards")
        registry.gauge("plan_pool.flops_fraction",
                       float(np.mean([s["flops_fraction"] for s in shards])),
                       pool="all_shards")

    def per_shard_summary(self) -> list[dict]:
        return [s["summary"] for s in self._gather()]

    def state_dict(self) -> list[dict]:
        """Every shard's plan-pool state, in shard order (the reference's
        list-of-shards layout)."""
        return self.group.gather_objects(self.local.state_dict())

    def load_state_dict(self, state) -> None:
        if state:
            self.local.load_state_dict(state[self.rank])

    # ------------------------------------------------------------- local
    def probe_entries(self):
        """Shard 0's latest subgraph, on rank 0 (the reference's choice:
        every shard runs the same allocator on statistically identical
        partitions); nothing on the other ranks."""
        return self.local.probe_entries() if self.rank == 0 else []


class ShardedPoolSource(PooledSource):
    """This rank's subgraph of every step, through the double-buffered
    :class:`Prefetcher`; the step's tag is the tuple of every rank's
    subgraph id. Evaluation, the order-RNG state, the resident LRU and
    pinned copies (this rank's) and the transfer counters are
    :class:`PooledSource`'s."""

    def __init__(self, pool: SubgraphPool, cfg, group):
        super().__init__(pool, cfg)
        self.group = group
        self.rank = group.rank
        self.device = group.device
        self.n_shards = group.world_size
        self.shards = shard_pool_ids(pool, self.n_shards)
        self.steps_per_epoch = len(pool) // self.n_shards

    def warmup(self, cfg, dims, n_classes) -> None:
        """Rank 0 sweeps the buckets' signatures; the other ranks then
        reload the cache file and find its decisions, so no two ranks
        time each other's noise or dispatch different tiles."""
        from repro_torch.kernels import autotune
        if self.group.is_main:
            super().warmup(cfg, dims, n_classes)
        self.group.barrier()
        if not self.group.is_main:
            autotune.reset(autotune.get_cache().path)
            super().warmup(cfg, dims, n_classes)

    def epoch_schedule(self, epoch: int) -> list[tuple[int, ...]]:
        """Bucket-grouped step schedule: every step's per-shard subgraphs
        come from the SAME shape bucket, with a shared shuffled bucket
        sequence and independent per-shard orders within each bucket."""
        rng = self._order_rng
        buckets = list(range(len(self.pool.buckets)))
        sub = self.pool.subgraphs
        per_shard = []
        for ids in self.shards:
            per_shard.append({
                b: [int(x) for x in rng.permutation(
                    [i for i in ids if sub[i].bucket_id == b]).tolist()]
                for b in buckets})
        counts = [len(per_shard[0][b]) for b in buckets]
        seq = rng.permutation(np.repeat(buckets, counts))
        return [tuple(per_shard[d][int(b)].pop()
                      for d in range(len(self.shards)))
                for b in seq]

    def batches(self, epoch: int, skip: int = 0):
        cfg = self.cfg
        # The whole schedule is drawn, so the RNG stream advances alike
        # under resume; ``skip`` trims what is uploaded and yielded.
        sched = self.epoch_schedule(epoch)[skip:]
        fetch = Prefetcher(
            self.pool, [t[self.rank] for t in sched], device=self.device,
            depth=cfg.prefetch_depth, enabled=cfg.prefetch,
            resident=cfg.resident, cache=self._device_cache,
            pinned=self._pinned)
        self.fetchers.append(("train", fetch))
        for tag, (_, ops) in zip(sched, fetch):
            yield tag, ops
