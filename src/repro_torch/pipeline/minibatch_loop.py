"""Minibatch GraphSAINT training as configurations of the Engine.

The port of ``repro.pipeline.minibatch_loop`` (single device). The loop
mechanics (switch-back schedule, step dispatch, history) live in
:mod:`repro_torch.train.engine`; this module supplies the pooled pieces:

* :class:`PooledSource` — prefetched subgraph-pool batches (one subgraph
  per step, shape-bucketed, double-buffered host→device upload);
* :class:`PooledPlanner` — the per-subgraph :class:`PlanCachePool` adapter
  (paper §3.3.1 footnote 1: caches per sampled subgraph, own clocks);
* :func:`tune_buckets` — the SpMM autotune sweep per bucket signature,
  before the first step;
* :func:`pooled_evaluate` — pooled evaluation with node-multiplicity
  dedup: logits of nodes shared by overlapping random-walk subgraphs are
  averaged in parent-graph id space and every node is scored exactly once;
* :func:`minibatch_engine` — the factory wiring pool, planner and source;
* :class:`MinibatchTrainer` — the reference's API, a thin shell.

The switch-back schedule (§3.3.2) runs on the GLOBAL step counter
(epochs × steps-per-epoch): the last (1−rsc_fraction) of all minibatch
steps are exact, mirroring the full-batch loop's tail.

One epoch = one pass over the pool in a seeded random order. With the
``ldg`` partitioner the parts are disjoint and cover the graph, so an epoch
touches every training node exactly once, like classic minibatch SGD.

Data parallelism (``dp > 1``): every rank of a ``DPGroup`` builds the same
pool and trains its own shard of it (``pipeline.sharding``), one
same-bucket subgraph per rank per step, the gradients all-reduced over the
group (``compress_grads``: through the int8 error-feedback compressor;
``overlap_allreduce``: in ``overlap_buckets`` buckets issued during the
backward). An epoch is then ``len(pool) / dp`` global steps. Every bucket
must split evenly across the shards: a pool built here whose buckets do
not is rebuilt with a single bucket, as the reference does; a prebuilt
pool raises, naming the bucket (:func:`dp_pool`).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from repro_torch import obs
from repro_torch.core.schedule import RSCSchedule
from repro_torch.device import resolve_device
from repro_torch.graphs.synthetic import GraphData
from repro_torch.models.gnn import MODELS
from repro_torch.pipeline.partition import PoolConfig, SubgraphPool, build_pool
from repro_torch.pipeline.plan_pool import PlanCachePool
from repro_torch.pipeline.prefetch import Prefetcher
from repro_torch.train.engine import Engine, TrainConfig


@dataclasses.dataclass
class MinibatchConfig(TrainConfig):
    """TrainConfig + pool / prefetch / data-parallel knobs.

    ``epochs`` = passes over the pool. ``resident`` keeps that many
    subgraphs' device operands alive across epochs (an LRU shared by
    training and evaluation; per rank under data parallelism). ``dp > 1``
    shards the pool over that many ranks of a ``DPGroup`` and all-reduces
    the gradients every step; ``compress_grads`` routes the all-reduce
    through the int8 error-feedback compressor (blocks of
    ``compress_block``), ``overlap_allreduce`` cuts it into
    ``overlap_buckets`` buckets issued during the backward.
    """

    n_subgraphs: int = 8
    method: str = "random_walk"      # or "ldg"
    roots: int = 200
    walk_length: int = 4
    n_buckets: int = 2
    prefetch: bool = True
    prefetch_depth: int = 2
    resident: int = 0                # device-resident subgraph cache size
    autotune: bool = True            # sweep the SpMM per bucket signature
    saint_norm: bool = True          # GraphSAINT λ/α bias correction
    # Data-parallel
    dp: int = 0                      # 0/1 = single device; N = shards
    compress_grads: bool = False     # int8 EF compression on the all-reduce
    compress_block: int = 128
    overlap_allreduce: bool = False  # bucketed all-reduce during backward
    overlap_buckets: int = 4


def tune_buckets(pool: SubgraphPool, cfg, dims: dict[str, int],
                 n_classes: int, device="cuda") -> dict[str, object]:
    """One autotuner sweep per (bucket shape × dim × plan length).

    Forward SpMMs run the bucket's exact plan (``s_pad`` tiles); sampled
    backward SpMMs run plans of ``plan_pad`` entries — both signatures get
    tuned so dispatch-time lookups hit. Every subgraph of a bucket shares
    the bucket's signature, so the decision is made once per bucket (and
    persists across processes through the JSON cache). The backend signed
    is the one dispatch resolves: ``kernel`` on the card, ``kernel_plain``
    for the kernel wrapper on the CPU; ``auto`` tunes the cross-backend
    decision (``get_or_tune_auto``).
    """
    from repro_torch.kernels import autotune

    device = resolve_device(device)
    backend = cfg.backend
    if backend == "kernel" and device.type != "cuda":
        backend = "kernel_plain"
    # feat_dim covers layer-0 SpMMs over raw features (GraphSAGE).
    dim_set = sorted({cfg.hidden, n_classes, pool.feat_dim, *dims.values()})
    tuned: dict[str, object] = {}
    for b in pool.buckets:
        for d in dim_set:
            for s_pad in sorted({b.s_pad, b.plan_pad}):
                shape = dict(bm=cfg.block, bk=cfg.block, d=d, s_pad=s_pad,
                             n_row_blocks=b.n_blocks, n_col_blocks=b.n_blocks)
                sig = autotune.signature(backend, **shape)
                if sig in tuned:
                    continue
                if backend == "auto":
                    tuned[sig] = autotune.get_or_tune_auto(**shape,
                                                           device=device)
                else:
                    tuned[sig] = autotune.get_or_tune(backend, **shape,
                                                      device=device)
    return tuned


def pooled_evaluate(pool: SubgraphPool, eval_fn, mfn, params, *,
                    device="cuda", prefetch: bool = True, depth: int = 2,
                    resident: int = 0, cache: OrderedDict | None = None,
                    pinned: dict | None = None,
                    fetchers: list | None = None) -> tuple[float, float]:
    """Pooled evaluation deduplicated by node multiplicity.

    Logits are accumulated in parent-graph id space — a node appearing in
    several overlapping subgraphs contributes the MEAN of its per-subgraph
    logits and is scored exactly once, so the metric is computed over the
    set of covered nodes, not the multiset of appearances. For disjoint
    ``ldg`` pools every node appears once. ``fetchers`` collects the
    Prefetcher used (for its transfer counters).
    """
    sum_logits: np.ndarray | None = None
    counts = np.zeros(pool.n_nodes, dtype=np.float32)
    fetch = Prefetcher(pool, range(len(pool)), device=device, depth=depth,
                       enabled=prefetch, resident=resident, cache=cache,
                       pinned=pinned)
    if fetchers is not None:
        fetchers.append(("eval", fetch))
    tracer = obs.get_tracer()
    for sid, ops in fetch:
        sub = pool.subgraphs[sid]
        with tracer.span("eval.logits", sub=int(sid)):
            with tracer.device_span("eval", ops.features.device):
                logits = eval_fn(params, ops)
            logits = logits.cpu().numpy()[: sub.n_valid]
        if sum_logits is None:
            sum_logits = np.zeros((pool.n_nodes, logits.shape[1]),
                                  dtype=np.float64)
        # parent ids are unique within one subgraph → plain fancy-index add
        sum_logits[sub.nodes] += logits
        counts[sub.nodes] += 1.0
    with tracer.span("eval.score"):
        seen = counts > 0
        mean_logits = (sum_logits / np.maximum(counts, 1.0)[:, None]
                       ).astype(np.float32)
        val = mfn(mean_logits, pool.node_labels, pool.node_val_mask & seen)
        test = mfn(mean_logits, pool.node_labels,
                   pool.node_test_mask & seen)
    return val, test


class PooledPlanner:
    """Engine planner adapter over the per-subgraph PlanCachePool."""

    def __init__(self, pool: SubgraphPool, names, dims, *,
                 budget_frac: float, step_frac: float, strategy: str,
                 refresh_every: int, device="cuda"):
        self.pool = pool
        self.plan_pool = PlanCachePool(
            pool, names, dims, budget_frac=budget_frac,
            step_frac=step_frac, strategy=strategy,
            refresh_every=refresh_every, device=device)

    def plans_for(self, tag, step: int, schedule: RSCSchedule):
        return self.plan_pool.plans_for(self.pool.subgraphs[int(tag)])

    def record(self, tag, norms) -> None:
        self.plan_pool.record_norms(int(tag), norms)

    def flops_fraction(self) -> float:
        return self.plan_pool.flops_fraction()

    def hit_rate(self) -> float | None:
        return self.plan_pool.stats.hit_rate

    def stats(self):
        return self.plan_pool.stats

    def k_latest(self):
        return None

    def publish(self, registry) -> None:
        self.plan_pool.publish(registry)

    def probe_entries(self):
        return self.plan_pool.probe_entries()

    def state_dict(self):
        return self.plan_pool.state_dict()

    def load_state_dict(self, state) -> None:
        self.plan_pool.load_state_dict(state)


class PooledSource:
    """Prefetched subgraph-pool batches: one subgraph per step."""

    def __init__(self, pool: SubgraphPool, cfg: MinibatchConfig):
        self.pool = pool
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.steps_per_epoch = len(pool)
        self.num_classes = pool.num_classes
        self.feat_dim = pool.feat_dim
        self.n_buckets = len(pool.buckets)
        self._order_rng = np.random.default_rng(cfg.seed)
        # Resident device-operand LRU shared by train epochs and eval
        # sweeps (None => upload every visit); pinned host copies of the
        # subgraphs' arrays, made once and shared the same way.
        self._device_cache = OrderedDict() if cfg.resident > 0 else None
        self._pinned: dict = {}
        self.fetchers: list[tuple[str, Prefetcher]] = []

    def warmup(self, cfg, dims, n_classes) -> None:
        tune_buckets(self.pool, cfg, dims, n_classes, device=self.device)

    def batches(self, epoch: int, skip: int = 0):
        cfg = self.cfg
        # The whole permutation is always drawn (the order RNG advances the
        # same whether or not a resume skips a prefix); ``skip`` only trims
        # what is uploaded and yielded.
        order = self._order_rng.permutation(len(self.pool))[skip:]
        fetch = Prefetcher(
            self.pool, order, device=self.device,
            depth=cfg.prefetch_depth, enabled=cfg.prefetch,
            resident=cfg.resident, cache=self._device_cache,
            pinned=self._pinned)
        self.fetchers.append(("train", fetch))
        for sid, ops in fetch:
            yield int(sid), ops

    def state_dict(self):
        """The order RNG's state (the epoch's cursor, with the engine's
        batch index)."""
        return {"order_rng": self._order_rng.bit_generator.state}

    def load_state_dict(self, state) -> None:
        if state is not None:
            self._order_rng.bit_generator.state = state["order_rng"]

    def evaluate(self, eval_fn, mfn, params) -> tuple[float, float]:
        cfg = self.cfg
        return pooled_evaluate(
            self.pool, eval_fn, mfn, params, device=self.device,
            prefetch=cfg.prefetch, depth=cfg.prefetch_depth,
            resident=cfg.resident, cache=self._device_cache,
            pinned=self._pinned, fetchers=self.fetchers)

    def transfer_stats(self, kind: str | None = None) -> dict:
        """Summed Prefetcher counters (``kind``: "train", "eval" or both)."""
        keys = ("uploads", "upload_seconds", "upload_bytes",
                "resident_hits", "stall_seconds")
        return {k: sum(getattr(f, k) for kd, f in self.fetchers
                       if kind is None or kd == kind) for k in keys}


def _build_default_pool(cfg: MinibatchConfig, graph: GraphData,
                        n_buckets: int | None = None) -> SubgraphPool:
    return build_pool(
        graph,
        PoolConfig(n_subgraphs=cfg.n_subgraphs, method=cfg.method,
                   roots=cfg.roots, walk_length=cfg.walk_length,
                   n_buckets=(cfg.n_buckets if n_buckets is None
                              else n_buckets),
                   block=cfg.block, degree_sort=cfg.degree_sort,
                   seed=cfg.seed, saint_norm=cfg.saint_norm),
        mean_agg=MODELS[cfg.model].uses_mean_agg())


def dp_pool(cfg: MinibatchConfig, graph: GraphData | None = None,
            pool: SubgraphPool | None = None) -> SubgraphPool:
    """The pool a run trains on: ``pool`` as given, or built from
    ``graph``. With ``dp > 1`` every bucket must split evenly across the
    shards: a pool built here that does not is rebuilt with one bucket (a
    pool size not divisible by ``dp`` is left for ``shard_pool_ids`` to
    report); a prebuilt pool must comply."""
    from repro_torch.pipeline.sharding import shard_pool_ids
    dp = int(cfg.dp or 0)
    if pool is None:
        if graph is None:
            raise ValueError("need a graph or a prebuilt pool")
        pool = _build_default_pool(cfg, graph)
        if dp > 1 and cfg.n_buckets > 1 and len(pool) % dp == 0:
            try:
                shard_pool_ids(pool, dp)
            except ValueError:
                pool = _build_default_pool(cfg, graph, n_buckets=1)
    if dp > 1:
        shard_pool_ids(pool, dp)
    return pool


def minibatch_engine(cfg: MinibatchConfig, graph: GraphData | None = None,
                     pool: SubgraphPool | None = None, *,
                     model=None, group=None) -> Engine:
    """Assemble the minibatch Engine: pooled, or with ``cfg.dp > 1`` this
    rank's sharded one (``group``: the rank's ``DPGroup``, of ``dp``
    ranks). ``model`` replaces the seeded initial parameters (see
    ``Engine``; under data parallelism rank 0's are broadcast)."""
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r} (expected one of "
                         f"{sorted(MODELS)})")
    module = MODELS[cfg.model]
    dp = int(cfg.dp or 0)
    pool = dp_pool(cfg, graph, pool)
    if module.uses_mean_agg() != pool.mean_agg:
        raise ValueError(
            f"pool built with mean_agg={pool.mean_agg} but model "
            f"{cfg.model!r} needs mean_agg={module.uses_mean_agg()}")

    names = module.spmm_names(cfg.n_layers)
    dims = module.spmm_dims(cfg.n_layers, cfg.hidden, pool.num_classes)
    refresh = cfg.refresh_every if cfg.caching else 1
    if dp > 1:
        from repro_torch.pipeline.sharding import (ShardedPlanner,
                                                   ShardedPoolSource)
        if group is None or group.world_size != dp:
            raise ValueError(
                f"dp={dp} trains on {dp} ranks: pass this rank's DPGroup "
                "(group=) of that size, e.g. from "
                "repro_torch.distributed.launch or the CLI's --dp")
        if resolve_device(cfg.device) != group.device:
            raise ValueError(f"cfg.device {cfg.device!r} is not the rank's "
                             f"device {group.device}")
        source = ShardedPoolSource(pool, cfg, group)
        planner = ShardedPlanner(
            pool, source.shards, names, dims, budget_frac=cfg.budget,
            step_frac=cfg.step_frac, strategy=cfg.strategy,
            refresh_every=refresh, group=group) if cfg.rsc else None
        return Engine(cfg, source, planner=planner, model=model,
                      graph=graph, group=group,
                      compress_grads=cfg.compress_grads,
                      compress_block=cfg.compress_block,
                      overlap_allreduce=cfg.overlap_allreduce,
                      overlap_buckets=cfg.overlap_buckets)

    source = PooledSource(pool, cfg)
    planner = PooledPlanner(
        pool, names, dims, budget_frac=cfg.budget,
        step_frac=cfg.step_frac, strategy=cfg.strategy,
        refresh_every=refresh, device=source.device) if cfg.rsc else None
    return Engine(cfg, source, planner=planner, model=model, graph=graph)


class MinibatchTrainer:
    """GraphSAINT-style minibatch trainer over a bucketed subgraph pool:
    a named configuration of :class:`repro_torch.train.engine.Engine`."""

    def __init__(self, cfg: MinibatchConfig, graph: GraphData | None = None,
                 pool: SubgraphPool | None = None, *, model=None,
                 group=None):
        self.cfg = cfg
        self.engine: Engine = minibatch_engine(cfg, graph, pool, model=model,
                                               group=group)
        self.pool: SubgraphPool = self.engine.source.pool
        self.module = MODELS[cfg.model]

    @property
    def params(self):
        return self.engine.model

    @property
    def plan_pool(self):
        return getattr(self.engine.planner, "plan_pool", None)

    @property
    def schedule(self):
        return self.engine.schedule

    @property
    def history(self):
        return self.engine.history

    def train(self, epochs: int | None = None, eval_every: int = 5,
              verbose: bool = False) -> dict:
        return self.engine.train(epochs=epochs, eval_every=eval_every,
                                 verbose=verbose)

    def evaluate(self, mfn=None) -> tuple[float, float]:
        return self.engine.evaluate(mfn)
