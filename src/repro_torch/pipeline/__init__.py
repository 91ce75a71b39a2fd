"""Minibatch subgraph pipeline: GraphSAINT training with per-subgraph RSC
plan caches and double-buffered prefetch, as configurations of the
``repro_torch.train.engine.Engine``; and the row-block partitioning of the
streaming forward (contiguous or LDG); the sharded pools of
data-parallel training (``sharding``)."""
from repro_torch.pipeline.minibatch_loop import (MinibatchConfig,
                                                 MinibatchTrainer,
                                                 PooledPlanner, PooledSource,
                                                 dp_pool, minibatch_engine,
                                                 pooled_evaluate,
                                                 tune_buckets)
from repro_torch.pipeline.partition import (Bucket, HostSubgraph, PoolConfig,
                                            SubgraphPool, build_pool,
                                            contiguous_block_partition,
                                            ldg_block_partition,
                                            ldg_partition, make_buckets)
from repro_torch.pipeline.plan_pool import PlanCachePool, PoolPlanStats
from repro_torch.pipeline.prefetch import Prefetcher, device_operands
from repro_torch.pipeline.sharding import (ShardedPlanner, ShardedPoolSource,
                                           shard_pool_ids)

__all__ = [
    "Bucket", "HostSubgraph", "MinibatchConfig", "MinibatchTrainer",
    "PlanCachePool", "PoolConfig", "PooledPlanner", "PooledSource",
    "PoolPlanStats", "Prefetcher", "ShardedPlanner", "ShardedPoolSource",
    "SubgraphPool", "build_pool", "contiguous_block_partition",
    "device_operands", "dp_pool", "ldg_block_partition", "ldg_partition",
    "make_buckets", "minibatch_engine", "pooled_evaluate", "shard_pool_ids",
    "tune_buckets",
]
