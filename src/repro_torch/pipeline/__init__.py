"""Minibatch subgraph pipeline: GraphSAINT training with per-subgraph RSC
plan caches and double-buffered prefetch, as configurations of the
``repro_torch.train.engine.Engine``; and the row-block partitioning of the
streaming forward (contiguous or LDG). The mesh-sharded data-parallel
pools are ROADMAP.md Queue 1 item 8."""
from repro_torch.pipeline.minibatch_loop import (MinibatchConfig,
                                                 MinibatchTrainer,
                                                 PooledPlanner, PooledSource,
                                                 minibatch_engine,
                                                 pooled_evaluate,
                                                 tune_buckets)
from repro_torch.pipeline.partition import (Bucket, HostSubgraph, PoolConfig,
                                            SubgraphPool, build_pool,
                                            contiguous_block_partition,
                                            ldg_block_partition,
                                            ldg_partition, make_buckets)
from repro_torch.pipeline.plan_pool import PlanCachePool, PoolPlanStats
from repro_torch.pipeline.prefetch import Prefetcher, device_operands

__all__ = [
    "Bucket", "HostSubgraph", "MinibatchConfig", "MinibatchTrainer",
    "PlanCachePool", "PoolConfig", "PooledPlanner", "PooledSource",
    "PoolPlanStats", "Prefetcher", "SubgraphPool", "build_pool",
    "contiguous_block_partition", "device_operands", "ldg_block_partition",
    "ldg_partition", "make_buckets", "minibatch_engine", "pooled_evaluate",
    "tune_buckets",
]
