"""Streaming full-graph inference and concurrent node serving.

``stream`` runs an exact (or RSC-sampled) layer-wise forward over the whole
graph one row-partition at a time under a device-memory budget; ``serve``
caches the resulting activations behind immutable versioned snapshots and
answers batched node queries without blocking on edge updates (dirty ≤L-hop
recompute, dirty-bounded incremental re-tiling); ``frontend`` replicates
servers behind a write-ahead update log and a query-batching dispatcher
with per-query staleness and an RSC-sampled latency/accuracy knob.
"""
from repro_torch.infer.stream import (StreamConfig, StreamEvaluator,
                                      StreamingInference)
from repro_torch.infer.serve import NodeServer, Snapshot
from repro_torch.infer.frontend import QueryResult, ServeFrontend, UpdateLog

__all__ = ["NodeServer", "QueryResult", "ServeFrontend", "Snapshot",
           "StreamConfig", "StreamEvaluator", "StreamingInference",
           "UpdateLog"]
