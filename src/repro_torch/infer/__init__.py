"""Streaming full-graph inference and node serving.

``stream`` runs the exact layer-wise forward over the whole graph one
row-partition at a time under a device-memory budget; ``serve`` caches the
resulting activations behind a refcounted snapshot and answers batched node
queries.
"""
from repro_torch.infer.serve import NodeServer, Snapshot
from repro_torch.infer.stream import (StreamConfig, StreamEvaluator,
                                      StreamingInference)

__all__ = ["NodeServer", "Snapshot", "StreamConfig", "StreamEvaluator",
           "StreamingInference"]
