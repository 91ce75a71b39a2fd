"""Versioned node-query serving on cached streaming-inference activations.

The port of ``repro.infer.serve`` (host logic copied). :class:`NodeServer`
runs one streaming full-graph forward pass up front
(``infer.stream``, ``store_layers=True``) and then answers batched
node-id queries from an immutable, refcounted :class:`Snapshot` of the
cached per-layer activations and final logits:

* **Queries never block on updates.** A query acquires the current
  snapshot (one refcount increment under a lock held for nanoseconds),
  reads from its arrays, and releases it. ``update_edges`` builds version
  N+1 *off to the side* — copy-on-write: the layer stores and logits are
  copied before the dirty rows are recomputed into the copies — and
  atomically publishes the new snapshot. Readers holding version N keep a
  consistent view; a superseded snapshot is retained only while drained
  readers still reference it, then dropped.
* **Host work is dirty-bounded like device work.** An inserted/removed
  edge (u, v) perturbs Ã rows of u, v and (through the degree rescaling
  of the normalization) their neighbors; each further SpMM layer widens
  the affected set by one hop — a dirty-set BFS over the union of the old
  and new CSR topology bounds the device recompute to the ≤L-hop
  neighborhood. With ``incremental=True`` (default) the HOST side is
  bounded too: ``sparse.bcoo.retile_rows`` rebuilds only the touched row
  blocks and ``StreamingInference.update_operand`` rebuilds only the
  partitions containing them. ``incremental=False`` keeps the full
  re-tile as the oracle the equivalence tests and benchmark compare
  against. Batchnorm statistics stay FROZEN at the last full pass
  (standard serving semantics); clean cached rows are untouched
  bit-for-bit.
* **Sampled serving replicas** (``sampled=True`` with a
  ``sample_budget`` < 1) build and refresh their stores with the
  RSC-sampled column gathers: cheaper updates (smaller gathers and
  recompute chunks) at a bounded, measured accuracy cost — the
  latency/accuracy SLO trade ``infer.frontend`` exposes per query.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.graphs.synthetic import GraphData
from repro_torch.infer.stream import StreamConfig, StreamingInference
from repro_torch.obs.clock import GuardedClock
from repro_torch.sparse.csr import CSR


def _edit_csr(adj: CSR, add: np.ndarray, remove: np.ndarray) -> CSR:
    """Apply undirected edge insertions/removals to a 0/1 CSR."""
    rows = np.repeat(np.arange(adj.n_rows, dtype=np.int64), adj.row_nnz())
    cols = adj.col.astype(np.int64)
    key = rows * adj.n_cols + cols
    if remove.size:
        drop = np.concatenate([remove[:, 0] * adj.n_cols + remove[:, 1],
                               remove[:, 1] * adj.n_cols + remove[:, 0]])
        keep = ~np.isin(key, drop)
        rows, cols, key = rows[keep], cols[keep], key[keep]
    if add.size:
        ar = np.concatenate([add[:, 0], add[:, 1]])
        ac = np.concatenate([add[:, 1], add[:, 0]])
        akey = ar * adj.n_cols + ac
        new = ~np.isin(akey, key)
        rows = np.concatenate([rows, ar[new]])
        cols = np.concatenate([cols, ac[new]])
    uniq = np.unique(rows * adj.n_cols + cols)
    rows, cols = uniq // adj.n_cols, uniq % adj.n_cols
    return CSR.from_coo(rows, cols, np.ones(rows.shape[0], np.float32),
                        adj.shape)


def _neighbors(adj: CSR, nodes: np.ndarray) -> np.ndarray:
    out = [adj.col[adj.rowptr[u]: adj.rowptr[u + 1]].astype(np.int64)
           for u in nodes]
    return (np.unique(np.concatenate(out)) if out
            else np.empty(0, np.int64))


@dataclasses.dataclass
class Snapshot:
    """One immutable published serving state.

    Arrays are never written after publication (updates copy-on-write
    into fresh arrays), so any number of readers may hold a version while
    the next one is being built. ``refs`` is guarded by the owning
    server's snapshot lock; a superseded snapshot is dropped as soon as
    its last reader releases it.
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
    """Cached-activation GNN serving: snapshot reads, versioned updates."""

    def __init__(self, graph: GraphData, model, params,
                 cfg: StreamConfig = StreamConfig(), *,
                 sampled: bool = False, incremental: bool = True,
                 warm_from: "NodeServer | None" = None, name: str = "r0"):
        budget = cfg.sample_budget if sampled else None
        if sampled and (budget is None or budget >= 1.0):
            raise ValueError("sampled serving needs a sample_budget < 1")
        cfg = dataclasses.replace(cfg, store_layers=True,
                                  sample_budget=budget)
        self.name = name
        self.sampled = sampled
        self.incremental = incremental
        self._mode = "sampled" if sampled else "exact"
        # Monotonic clock with a negative-delta guard: serving metrics must
        # never go backwards even if a timer source misbehaves; anomalies
        # are counted, not silently folded into latencies.
        self.clock = GuardedClock()
        t0 = self.clock.now()
        self.si = StreamingInference(graph, model, params, cfg)
        applied_seq = 0
        if warm_from is not None:
            # Replica warm start: share the source's current (immutable)
            # snapshot arrays instead of re-running the full forward; the
            # first update copy-on-writes them, so sharing is safe. The
            # operand/partitions above are still built privately — updates
            # mutate them in place.
            if warm_from.sampled != sampled:
                raise ValueError("warm_from must match the sampled mode")
            src = warm_from.acquire_snapshot()
            try:
                self.si.layer_store = list(src.layer_store)
                self.si.logits = src.logits
                self.si.bn_stats = dict(src.bn_stats)
                self.si.ctx_store = src.ctx_store
                applied_seq = src.applied_seq
            finally:
                warm_from.release_snapshot(src)
        else:
            self.si.forward(store=True)
        self.build_seconds = self.clock.elapsed(t0)
        self.queries = 0
        self.query_seconds = 0.0
        self.updates = 0
        self.versions_dropped = 0
        self.applied_seq = applied_seq
        self.last_dirty: np.ndarray | None = None   # local rows, last update
        self.last_retile: dict | None = None
        self.last_update: dict | None = None
        self._lock = threading.Lock()          # snapshot publish/refcount
        self._update_lock = threading.Lock()   # serializes update_edges
        self._retired: list[Snapshot] = []
        self._snap = Snapshot(
            version=0, logits=self.si.logits,
            layer_store=list(self.si.layer_store),
            bn_stats=dict(self.si.bn_stats), ctx_store=self.si.ctx_store,
            applied_seq=applied_seq, created_at=time.time())
        obs.get_registry().gauge("serve.build_seconds", self.build_seconds,
                                 replica=self.name)

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
            if snap is not self._snap and snap.refs <= 0:
                try:
                    self._retired.remove(snap)
                    self.versions_dropped += 1
                    obs.get_registry().counter("serve.snapshots_dropped",
                                               replica=self.name)
                except ValueError:
                    pass

    def _publish(self, applied_seq: int) -> Snapshot:
        snap = Snapshot(
            version=self._snap.version + 1, logits=self.si.logits,
            layer_store=list(self.si.layer_store),
            bn_stats=dict(self.si.bn_stats), ctx_store=self.si.ctx_store,
            applied_seq=applied_seq, created_at=time.time())
        with self._lock:
            old, self._snap = self._snap, snap
            if old.refs > 0:
                self._retired.append(old)   # drained readers drop it
            else:
                self.versions_dropped += 1
            self.applied_seq = applied_seq
            obs.get_registry().gauge("serve.live_versions",
                                     1 + len(self._retired),
                                     replica=self.name)
        return snap

    # ------------------------------------------------------------- query
    def query(self, node_ids, *, with_meta: bool = False,
              phases: dict | None = None):
        """Batched logits for original-graph node ids — a snapshot read,
        never blocked by an in-flight update. ``with_meta`` also returns
        ``(version, applied_seq, created_at)`` of the answering snapshot.
        ``phases``, when given a dict, is filled with the read's internal
        phase timings in ms: ``pin_ms`` (snapshot acquire under the
        version lock) and ``gather_ms`` (logits gather + copy) — the tail
        attribution the frontend folds into each ``QueryResult``.
        """
        t0 = self.clock.now()
        ids = np.asarray(node_ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_nodes):
            raise IndexError(f"node ids must be in [0, {self.n_nodes})")
        tp0 = time.perf_counter()
        snap = self.acquire_snapshot()
        tp1 = time.perf_counter()
        try:
            out = snap.logits[self.si.pos[ids]].copy()
        finally:
            tg1 = time.perf_counter()
            self.release_snapshot(snap)
        if phases is not None:
            phases["pin_ms"] = (tp1 - tp0) * 1e3
            phases["gather_ms"] = (tg1 - tp1) * 1e3
        dt = self.clock.elapsed(t0)
        with self._lock:     # answer workers may read one replica at once
            self.queries += ids.size
            self.query_seconds += dt
        reg = obs.get_registry()
        reg.observe("serve.query_ms", dt * 1e3, replica=self.name)
        reg.counter("serve.queries", float(ids.size), replica=self.name)
        if with_meta:
            return out, (snap.version, snap.applied_seq, snap.created_at)
        return out

    def predict(self, node_ids) -> np.ndarray:
        """argmax class per queried node (multilabel: sigmoid>0.5 mask)."""
        logits = self.query(node_ids)
        if self.si.multilabel:
            return (logits > 0.0).astype(np.int32)
        return logits.argmax(axis=-1).astype(np.int32)

    # ----------------------------------------------------- edge updates
    def _dirty_sets(self, old_adj: CSR, new_adj: CSR,
                    seeds: np.ndarray) -> list[np.ndarray]:
        """Per-layer dirty LOCAL row sets: one BFS hop per SpMM layer.

        Layer 1 outputs change for the seed endpoints and (degree
        rescaling of the normalization) every neighbor of a seed; each
        later layer widens by one hop. Old and new topology are both
        expanded so removals invalidate their former neighborhoods too.
        """
        dirty = np.unique(seeds)
        out = []
        for _ in range(self.si.n_layers):
            grown = np.union1d(dirty, np.union1d(
                _neighbors(old_adj, dirty), _neighbors(new_adj, dirty)))
            out.append(grown)
            dirty = grown
        return out

    def update_edges(self, add=(), remove=(), *, seq: int | None = None
                     ) -> dict:
        """Apply undirected edge updates (original-id pairs); recompute
        only the dirty ≤L-hop neighborhood into a NEW snapshot version
        published atomically at the end — concurrent queries keep reading
        the previous version and never block. Returns update statistics.

        Both sides are dirty-bounded: device recompute by the BFS dirty
        set, host re-tiling by the touched row blocks
        (``incremental=True``; ``False`` keeps the full-rebuild oracle).
        ``seq`` stamps the published snapshot with a write-ahead-log
        sequence number (``infer.frontend``). The statistics also hold the
        SpMM chunks ``recompute_rows`` ran per layer and its seconds, and
        stay readable as ``last_update``.
        """
        with self._update_lock:
            return self._update_locked(add, remove, seq)

    def _update_locked(self, add, remove, seq) -> dict:
        t0 = self.clock.now()
        add = np.asarray(list(add), dtype=np.int64).reshape(-1, 2)
        remove = np.asarray(list(remove), dtype=np.int64).reshape(-1, 2)
        if add.size + remove.size == 0:
            return {"edges": 0, "dirty_nodes": 0, "seconds": 0.0,
                    "version": self._snap.version}
        pos = self.si.pos
        add_l = pos[add] if add.size else add
        remove_l = pos[remove] if remove.size else remove

        old_adj = self.si.adj
        new_adj = _edit_csr(old_adj, add_l, remove_l)
        seeds = np.concatenate([add_l.reshape(-1),
                                remove_l.reshape(-1)]).astype(np.int64)
        dirty = self._dirty_sets(old_adj, new_adj, seeds)

        si = self.si
        # Copy-on-write: version N's arrays stay untouched for readers;
        # the dirty rows are recomputed into fresh copies.
        si.layer_store = [a.copy() for a in si.layer_store]
        si.logits = si.logits.copy()

        t_retile0 = self.clock.now()
        if self.incremental:
            # operand rows whose Ã values changed = dirty[0] (endpoints +
            # old∪new neighbors, the degree-renormalized rows)
            retile = si.update_operand(new_adj, dirty[0])
        else:
            si.rebuild_operand(new_adj)
            retile = {"dirty_row_blocks": int(
                np.unique(dirty[0] // si.host.bm).shape[0]),
                "partitions_touched": si.n_partitions,
                "partitions_rebuilt": sum(len(p)
                                          for p in si._parts.values()),
                "fallback": True}
        retile_s = self.clock.elapsed(t_retile0)
        self.last_retile = dict(retile, seconds=retile_s)

        t_rec0 = self.clock.now()
        chunks = si.recompute_rows(dirty, mode=self._mode)
        recompute_s = self.clock.elapsed(t_rec0)
        self.updates += 1
        self.last_dirty = dirty[-1]
        seq = seq if seq is not None else self.applied_seq + 1
        snap = self._publish(seq)
        n_pad = si.host.n_rows
        dt = self.clock.elapsed(t0)
        reg = obs.get_registry()
        reg.observe("serve.update_ms", dt * 1e3, replica=self.name)
        reg.observe("serve.rebuild_ms", dt * 1e3, replica=self.name)
        reg.observe("serve.retile_ms", retile_s * 1e3, replica=self.name,
                    mode="incremental" if self.incremental else "full")
        reg.counter("serve.updates", replica=self.name)
        reg.counter("serve.dirty_nodes", float(dirty[-1].shape[0]),
                    replica=self.name)
        reg.observe("serve.dirty_frac",
                    dirty[-1].shape[0] / max(self.n_nodes, 1))
        self.last_update = {
            "edges": int(add.shape[0] + remove.shape[0]),
            "dirty_nodes": int(dirty[-1].shape[0]),
            "dirty_frac": float(dirty[-1].shape[0] / max(self.n_nodes, 1)),
            "dirty_per_layer": [int(d.shape[0]) for d in dirty],
            "recomputed_row_frac": float(
                np.unique(dirty[-1] // si.host.bm).shape[0]
                * si.host.bm / n_pad),
            "retile": self.last_retile,
            "recompute_chunks": chunks,
            "recompute_seconds": recompute_s,
            "version": snap.version,
            "seconds": dt,
        }
        return self.last_update

    def stats(self) -> dict:
        with self._lock:
            retired = len(self._retired)
        return {
            "name": self.name,
            "n_nodes": self.n_nodes,
            "n_partitions": self.si.n_partitions,
            "build_seconds": round(self.build_seconds, 4),
            "queries": self.queries,
            "query_seconds": round(self.query_seconds, 6),
            "updates": self.updates,
            "version": self._snap.version,
            "applied_seq": self.applied_seq,
            "retired_versions_live": retired,
            "versions_dropped": self.versions_dropped,
            "sampled": self.sampled,
            "incremental": self.incremental,
            "clock_anomalies": self.clock.anomalies,
        }
