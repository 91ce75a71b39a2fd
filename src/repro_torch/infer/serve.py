"""Node-query serving on cached streaming-inference activations.

:class:`NodeServer` runs one streaming full-graph forward pass up front
(``infer.stream``, ``store_layers=True``) and answers batched node-id
queries from an immutable, refcounted :class:`Snapshot` of the cached
per-layer activations and final logits, as the reference's server
(``repro/infer/serve.py``) does. Batchnorm statistics are those of the full
pass, frozen with the snapshot.

Still to be ported: edge updates (dirty-set recompute into a new snapshot
version), sampled replicas and warm starts.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.graphs.synthetic import GraphData
from repro_torch.infer.stream import StreamConfig, StreamingInference
from repro_torch.obs.clock import GuardedClock


@dataclasses.dataclass
class Snapshot:
    """One immutable published serving state.

    Arrays are never written after publication. ``refs`` is guarded by the
    owning server's snapshot lock.
    """

    version: int
    logits: np.ndarray
    layer_store: list
    bn_stats: dict
    ctx_store: np.ndarray | None
    applied_seq: int          # last update-log sequence reflected
    created_at: float         # wall-clock publication time
    refs: int = 0


class NodeServer:
    """Cached-activation GNN serving: snapshot reads of full-graph logits."""

    def __init__(self, graph: GraphData, model, params,
                 cfg: StreamConfig = StreamConfig(), *, name: str = "r0"):
        cfg = dataclasses.replace(cfg, store_layers=True)
        self.name = name
        # Monotonic clock with a negative-delta guard: serving metrics must
        # never go backwards; anomalies are counted, not folded into
        # latencies.
        self.clock = GuardedClock()
        t0 = self.clock.now()
        self.si = StreamingInference(graph, model, params, cfg)
        self.si.forward(store=True)
        self.build_seconds = self.clock.elapsed(t0)
        self.queries = 0
        self.query_seconds = 0.0
        self.applied_seq = 0
        self._lock = threading.Lock()          # snapshot refcount
        self._snap = Snapshot(
            version=0, logits=self.si.logits,
            layer_store=list(self.si.layer_store),
            bn_stats=dict(self.si.bn_stats), ctx_store=self.si.ctx_store,
            applied_seq=0, created_at=time.time())

    @property
    def n_nodes(self) -> int:
        return self.si.n_valid

    @property
    def version(self) -> int:
        return self._snap.version

    # ---------------------------------------------------------- snapshots
    def acquire_snapshot(self) -> Snapshot:
        """Pin the current snapshot for reading (pair with release)."""
        with self._lock:
            snap = self._snap
            snap.refs += 1
            return snap

    def release_snapshot(self, snap: Snapshot) -> None:
        with self._lock:
            snap.refs -= 1

    # ------------------------------------------------------------- query
    def query(self, node_ids) -> np.ndarray:
        """Batched logits for original-graph node ids — a snapshot read."""
        t0 = self.clock.now()
        ids = np.asarray(node_ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_nodes):
            raise IndexError(f"node ids must be in [0, {self.n_nodes})")
        snap = self.acquire_snapshot()
        try:
            out = snap.logits[self.si.pos[ids]].copy()
        finally:
            self.release_snapshot(snap)
        dt = self.clock.elapsed(t0)
        with self._lock:
            self.queries += ids.size
            self.query_seconds += dt
        return out

    def predict(self, node_ids) -> np.ndarray:
        """argmax class per queried node (multilabel: logit>0 mask)."""
        logits = self.query(node_ids)
        if self.si.multilabel:
            return (logits > 0.0).astype(np.int32)
        return logits.argmax(axis=-1).astype(np.int32)

    def stats(self) -> dict:
        return {
            "name": self.name,
            "n_nodes": self.n_nodes,
            "n_partitions": self.si.n_partitions,
            "build_seconds": round(self.build_seconds, 4),
            "queries": self.queries,
            "query_seconds": round(self.query_seconds, 6),
            "version": self._snap.version,
            "applied_seq": self.applied_seq,
            "clock_anomalies": self.clock.anomalies,
        }
