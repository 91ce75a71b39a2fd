"""Replicated batching front-end over versioned :class:`NodeServer`s.

The port of ``repro.infer.frontend`` (Python threads, copied).

The serving tier that takes concurrent traffic: N replicas answer
snapshot reads while a write-ahead update log feeds them edge updates
one replica at a time.

* **Write-ahead update log.** ``update_edges`` appends to an in-memory
  :class:`UpdateLog` and returns immediately with the log sequence
  number; a background applier drains the log in order, applying each
  entry to the replicas ROUND-ROBIN — strictly one replica rebuilding at
  any moment, so the rest of the fleet serves the freshest published
  version with zero rebuild shadow. Late-built replicas catch up from the
  log (``UpdateLog.since``).
* **Query batching.** Queries enter a queue; a dispatcher thread
  coalesces everything pending (up to ``max_batch`` ids) into ONE
  vectorized snapshot read against the next replica in rotation
  (replicas mid-rebuild are skipped — their snapshot would answer too,
  just staler). The device-side batched calls live on the update path:
  dirty recompute chunks reuse the one-compile-per-layer padded shapes
  of ``infer.stream``, so no replica ever retraces under traffic.
* **Per-query staleness + sampled SLO trade.** Every response carries
  the answering snapshot's version and its lag behind the log head. A
  query may pass ``error_budget``: if the frontend runs a sampled
  replica (``sampled_budget`` < 1) whose measured relative error fits
  the budget, the query is routed there — sampled replicas rebuild
  faster (smaller gathers), trading accuracy for freshness/latency
  explicitly. The routing threshold is the UPPER bootstrap confidence
  bound of the measured error (re-probed after every update drain), not
  a point estimate: a budget only routes sampled when the whole CI fits
  under it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch import obs
from repro_torch.graphs.synthetic import GraphData
from repro_torch.infer.serve import NodeServer
from repro_torch.infer.stream import StreamConfig
from repro_torch.obs.context import TraceContext, new_trace
from repro_torch.obs.taillog import TailLog

_STOP = object()


class LabelCap:
    """Bounds the distinct values a metric label may take.

    The first ``limit`` distinct values pass through; every later value
    maps to ``"other"`` — an unbounded replica fleet (or adversarial
    names) can no longer blow up the registry's key space or the
    exposition payload.
    """

    def __init__(self, limit: int = 8, overflow: str = "other"):
        self.limit = int(limit)
        self.overflow = overflow
        self._seen: set[str] = set()
        # Dispatcher, answer workers and the updater all label metrics
        # concurrently; without the lock two racing first-sightings could
        # both pass the size check and overshoot the cap.
        self._lock = threading.Lock()

    def __call__(self, value: str) -> str:
        with self._lock:
            if value in self._seen:
                return value
            if len(self._seen) < self.limit:
                self._seen.add(value)
                return value
            return self.overflow


class UpdateLog:
    """In-memory write-ahead log of edge-update batches (1-based seq).

    Each entry optionally carries the submitter's
    :class:`~repro_torch.obs.context.TraceContext`, so the applier's rebuild
    spans (and the streaming recompute underneath them) link back to the
    ``update_edges`` call that caused them.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: list[tuple] = []

    def append(self, add, remove, ctx: TraceContext | None = None) -> int:
        add = np.asarray(list(add), dtype=np.int64).reshape(-1, 2)
        remove = np.asarray(list(remove), dtype=np.int64).reshape(-1, 2)
        with self._lock:
            seq = len(self._entries) + 1
            self._entries.append((seq, add, remove, ctx))
            return seq

    def since(self, seq: int) -> list[tuple]:
        """Entries with sequence number > ``seq`` (replica catch-up)."""
        with self._lock:
            return self._entries[seq:]

    @property
    def latest_seq(self) -> int:
        with self._lock:
            return len(self._entries)


@dataclasses.dataclass
class QueryResult:
    """One answered (sub-)query with its consistency metadata."""

    logits: np.ndarray
    version: int          # snapshot version of the answering replica
    applied_seq: int      # log seq that snapshot reflects
    staleness: int        # log entries not yet reflected in the answer
    replica: str
    sampled: bool
    queue_ms: float       # submit → dispatch wait
    trace_id: str | None = None   # causal trace id (tracing enabled)
    # Phase breakdown of the request's wall-clock: queue_ms (submit →
    # dispatcher pickup), batch_ms (batch formation), handoff_ms
    # (dispatcher → answer worker), pin_ms (snapshot acquire), gather_ms
    # (logits gather), answer_ms (worker total), total_ms (submit →
    # answered), and — filled in by ``wait()``, the only place it is
    # measurable — wake_ms (answered → waiter resumed). Staleness lag
    # rides separately in ``staleness`` (log entries, not time).
    phases: dict | None = None


class _Request:
    __slots__ = ("ids", "sampled", "event", "result", "error", "t_submit",
                 "deadline", "ctx", "t_done")

    def __init__(self, ids: np.ndarray, sampled: bool,
                 deadline: float | None = None,
                 ctx: TraceContext | None = None):
        self.ids = ids
        self.sampled = sampled
        self.event = threading.Event()
        self.result: QueryResult | None = None
        self.error: BaseException | None = None
        self.t_submit = time.perf_counter()
        self.deadline = deadline   # absolute perf_counter cutoff, or None
        self.ctx = ctx
        self.t_done: float | None = None   # stamped before event.set()

    def wait(self, timeout: float | None) -> QueryResult:
        ok = self.event.wait(timeout)
        now = time.perf_counter()
        if self.ctx is not None:
            tracer = obs.get_tracer()
            if self.t_done is not None:
                # Client-side wake latency: the only interval no serving
                # thread can attribute.
                tracer.span_at(self.ctx, "wake", self.t_done, now)
            tracer.span_at(self.ctx, "request", self.t_submit, now,
                           n_ids=int(self.ids.size), sampled=self.sampled)
        if not ok:
            raise TimeoutError("query not answered in time")
        if self.error is not None:
            raise self.error
        if (self.result is not None and self.result.phases is not None
                and self.t_done is not None):
            # Only the waiter can time its own wake-up; under load (a
            # rebuild holding the GIL) this is the dominant unattributed
            # tail phase, so it goes into the breakdown too.
            self.result.phases["wake_ms"] = (now - self.t_done) * 1e3
        return self.result


class ServeFrontend:
    """N exact replicas (+ optional sampled replica) behind one queue."""

    def __init__(self, graph: GraphData, model, params,
                 cfg: StreamConfig = StreamConfig(), *,
                 replicas: int = 2, max_batch: int = 256,
                 sampled_budget: float | None = None,
                 incremental: bool = True, slow_k: int = 16):
        if replicas < 1:
            raise ValueError("need at least one replica")
        self.max_batch = int(max_batch)
        self.log = UpdateLog()
        # Slowest-K tail reservoir: always on (O(log K) per request),
        # served at /debug/slow; slow_k=0 disables.
        self.taillog = TailLog(k=slow_k) if slow_k > 0 else None
        first = NodeServer(graph, model, params, cfg,
                           incremental=incremental, name="r0")
        self.replicas = [first] + [
            NodeServer(graph, model, params, cfg, incremental=incremental,
                       warm_from=first, name=f"r{i}")
            for i in range(1, replicas)]
        self.sampled_server: NodeServer | None = None
        self.sampled_rel_error = float("inf")
        self.sampled_rel_ci = (float("inf"), float("inf"))
        self._replica_label = LabelCap(limit=max(8, replicas + 2))
        if sampled_budget is not None and sampled_budget < 1.0:
            scfg = dataclasses.replace(cfg, sample_budget=sampled_budget)
            self.sampled_server = NodeServer(
                graph, model, params, scfg, sampled=True,
                incremental=incremental, name="sampled")
            self._probe_sampled_error()

        self._rr = 0
        self._queue: queue.Queue = queue.Queue()
        self._apply_cond = threading.Condition()
        self._applying = False
        self._error: BaseException | None = None
        self._closed = False
        # Answer pool: the dispatcher only forms batches and picks the
        # replica (keeping rotation deterministic); the snapshot read for
        # batch t runs on a worker while batch t+1 is already forming —
        # and gives every query a third thread track for its trace.
        n_workers = min(len(self.replicas)
                        + (1 if self.sampled_server else 0) + 1, 8)
        self._pool = ThreadPoolExecutor(max_workers=n_workers,
                                        thread_name_prefix="serve-answer")
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="serve-dispatch")
        self._updater = threading.Thread(
            target=self._update_loop, daemon=True, name="serve-update")
        self._dispatcher.start()
        self._updater.start()

    # ------------------------------------------------------- error probe
    def _probe_sampled_error(self, max_nodes: int = 2048,
                             n_boot: int = 200) -> None:
        """Measure the sampled replica's relative error with a bootstrap CI.

        Point estimate: the global Frobenius ratio ‖approx − exact‖/‖exact‖
        over the two live snapshots. The CI bootstraps the SAME statistic
        over node resamples (per-node squared norms are sufficient), so it
        brackets the point estimate tightly on homogeneous graphs and
        widens exactly when a few nodes dominate the error — the case
        where trusting a point estimate mis-routes. The CI is clamped to
        contain the point estimate, keeping routing monotone in the
        budget.
        """
        first = self.replicas[0]
        exact = np.asarray(first._snap.logits[: first.n_nodes],
                           dtype=np.float64)
        approx = np.asarray(
            self.sampled_server._snap.logits[: first.n_nodes],
            dtype=np.float64)
        d2 = np.sum((approx - exact) ** 2, axis=-1)
        e2 = np.sum(exact ** 2, axis=-1)
        point = float(np.sqrt(d2.sum() / max(e2.sum(), 1e-18)))
        rng = np.random.default_rng(0)
        if d2.size > max_nodes:
            sub = rng.choice(d2.size, size=max_nodes, replace=False)
            d2, e2 = d2[sub], e2[sub]
        idx = rng.integers(0, d2.size, size=(n_boot, d2.size))
        ratios = np.sqrt(d2[idx].sum(axis=1)
                         / np.maximum(e2[idx].sum(axis=1), 1e-18))
        lo, hi = np.percentile(ratios, [2.5, 97.5])
        self.sampled_rel_error = point
        self.sampled_rel_ci = (float(min(lo, point)), float(max(hi, point)))
        reg = obs.get_registry()
        reg.gauge("frontend.sampled_rel_error", point)
        reg.gauge("frontend.sampled_rel_ci_lo", self.sampled_rel_ci[0])
        reg.gauge("frontend.sampled_rel_ci_hi", self.sampled_rel_ci[1])

    # -------------------------------------------------------------- query
    def submit(self, node_ids, *, error_budget: float | None = None,
               timeout: float | None = None) -> _Request:
        """Enqueue a query; returns a waitable request handle.

        ``timeout`` propagates the caller's deadline into the request:
        the dispatcher drops requests whose deadline already passed
        instead of performing a snapshot read whose waiter has raised
        ``TimeoutError`` (counted as ``frontend.deadline_dropped``).
        Every submit gets a fresh trace context when tracing is on.
        """
        self._check_error()
        if self._closed:
            raise RuntimeError("frontend closed")
        ids = np.asarray(node_ids, dtype=np.int64)
        use_sampled = (error_budget is not None
                       and self.sampled_server is not None
                       and error_budget >= self.sampled_rel_ci[1])
        ctx = new_trace() if obs.get_tracer().enabled else None
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        req = _Request(ids, use_sampled, deadline=deadline, ctx=ctx)
        obs.get_registry().counter("frontend.requests")
        self._queue.put(req)
        return req

    def query(self, node_ids, *, error_budget: float | None = None,
              timeout: float | None = 30.0) -> QueryResult:
        """Synchronous query through the batching queue."""
        return self.submit(node_ids, error_budget=error_budget,
                           timeout=timeout).wait(timeout)

    # ------------------------------------------------------------ updates
    def update_edges(self, add=(), remove=(), *, wait: bool = False,
                     timeout: float | None = 60.0) -> int:
        """Append an update batch to the write-ahead log; the background
        applier pushes it to the replicas round-robin. Returns the log
        sequence number; ``wait=True`` blocks until every replica has
        applied it."""
        self._check_error()
        tracer = obs.get_tracer()
        ctx = new_trace() if tracer.enabled else None
        t0 = time.perf_counter()
        seq = self.log.append(add, remove, ctx=ctx)
        if ctx is not None:
            tracer.span_at(ctx, "update_submit", t0, time.perf_counter(),
                           seq=seq)
        with self._apply_cond:
            self._apply_cond.notify_all()
        if wait:
            self.wait_applied(seq, timeout=timeout)
        return seq

    def min_applied_seq(self) -> int:
        servers = self.replicas + ([self.sampled_server]
                                   if self.sampled_server else [])
        return min(s.applied_seq for s in servers)

    def wait_applied(self, seq: int, timeout: float | None = 60.0) -> None:
        deadline = (time.perf_counter() + timeout) if timeout else None
        with self._apply_cond:
            while self.min_applied_seq() < seq:
                self._check_error()
                remaining = (deadline - time.perf_counter()
                             if deadline else None)
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"update {seq} not applied in time")
                self._apply_cond.wait(timeout=remaining)

    # ----------------------------------------------------------- internals
    def _check_error(self):
        if self._error is not None:
            raise RuntimeError("serving thread died") from self._error

    def _pick_replica(self) -> NodeServer:
        """Next exact replica in rotation, skipping one mid-rebuild (its
        snapshot would answer fine, just staler)."""
        n = len(self.replicas)
        for off in range(n):
            srv = self.replicas[(self._rr + off) % n]
            if not srv._update_lock.locked():
                self._rr = (self._rr + off + 1) % n
                return srv
        srv = self.replicas[self._rr]
        self._rr = (self._rr + 1) % n
        return srv

    def _dispatch_loop(self):
        reg = obs.get_registry()
        tracer = obs.get_tracer()
        batch: list[_Request] = []
        try:
            while True:
                req = self._queue.get()
                if req is _STOP:
                    self._drain_closed()
                    return
                t_pickup = time.perf_counter()
                batch = [req]
                n_ids = req.ids.size
                while n_ids < self.max_batch:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _STOP:
                        self._queue.put(_STOP)
                        break
                    batch.append(nxt)
                    n_ids += nxt.ids.size
                # Abandoned waiters: the submit deadline already passed,
                # the client raised TimeoutError — a snapshot read for
                # them is dead work. Drop before forming the batch.
                live = []
                for r in batch:
                    if r.deadline is not None and t_pickup > r.deadline:
                        r.error = TimeoutError(
                            "deadline exceeded before dispatch")
                        r.t_done = t_pickup
                        reg.counter("frontend.deadline_dropped")
                        r.event.set()
                        continue
                    live.append(r)
                batch = live
                if not batch:
                    continue
                latest = self.log.latest_seq
                for sampled in (False, True):
                    group = [r for r in batch if r.sampled is sampled]
                    if not group:
                        continue
                    # Replica rotation stays on the dispatcher thread so
                    # round-robin order is deterministic; the snapshot
                    # read itself runs on the answer pool.
                    srv = (self.sampled_server if sampled
                           else self._pick_replica())
                    t_handoff = time.perf_counter()
                    if tracer.enabled:
                        for r in group:
                            if r.ctx is None:
                                continue
                            tracer.span_at(r.ctx, "queue",
                                           r.t_submit, t_pickup)
                            tracer.span_at(r.ctx, "batch_form",
                                           t_pickup, t_handoff,
                                           batch=len(group),
                                           replica=srv.name)
                    self._pool.submit(self._answer, group, srv, sampled,
                                      latest, reg, t_pickup, t_handoff)
        except BaseException as e:   # surface on the next caller
            self._error = e
            for r in batch:
                if not r.event.is_set():
                    r.error = e
                    r.event.set()

    def _drain_closed(self):
        """Fail every request still queued at shutdown instead of leaving
        its waiter to hit the timeout."""
        err = RuntimeError("frontend closed")
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                return
            if r is _STOP:
                continue
            r.error = err
            r.event.set()

    def _answer(self, group, srv: NodeServer, sampled: bool, latest: int,
                reg, t_pickup: float, t_handoff: float):
        """Answer one batch on the pool; never raises (pool would eat it).

        Fills each request's :class:`QueryResult` with the full phase
        breakdown, records the worker-side spans, and offers the request
        to the slowest-K tail reservoir."""
        tracer = obs.get_tracer()
        t_w0 = time.perf_counter()
        try:
            # Metric label, not identity: capped cardinality (overflow
            # lands in "other") so a large fleet cannot blow up the
            # registry.
            rlabel = self._replica_label(srv.name)
            ids = np.concatenate([r.ids for r in group])
            sphases: dict = {}
            out, (version, applied, created) = srv.query(
                ids, with_meta=True, phases=sphases)
            t_done = time.perf_counter()
            pin_ms = sphases.get("pin_ms", 0.0)
            gather_ms = sphases.get("gather_ms", 0.0)
            reg.observe("frontend.batch_size", float(ids.size),
                        replica=rlabel)
            reg.observe("frontend.batch_requests", float(len(group)))
            reg.observe("frontend.snapshot_age_ms",
                        max(time.time() - created, 0.0) * 1e3,
                        replica=rlabel)
            reg.gauge("frontend.staleness", float(latest - applied),
                      replica=rlabel)
            off = 0
            staleness = max(latest - applied, 0)
            for r in group:
                phases = {
                    "queue_ms": (t_pickup - r.t_submit) * 1e3,
                    "batch_ms": (t_handoff - t_pickup) * 1e3,
                    "handoff_ms": (t_w0 - t_handoff) * 1e3,
                    "pin_ms": pin_ms,
                    "gather_ms": gather_ms,
                    "answer_ms": (t_done - t_w0) * 1e3,
                    "total_ms": (t_done - r.t_submit) * 1e3,
                }
                r.result = QueryResult(
                    logits=out[off: off + r.ids.size], version=version,
                    applied_seq=applied, staleness=staleness,
                    replica=srv.name, sampled=sampled,
                    queue_ms=phases["queue_ms"],
                    trace_id=(r.ctx.trace_id if r.ctx else None),
                    phases=phases)
                reg.observe("frontend.queue_wait_ms", phases["queue_ms"],
                            replica=rlabel)
                reg.observe("frontend.request_ms", phases["total_ms"],
                            replica=rlabel)
                off += r.ids.size
                if r.ctx is not None:
                    tracer.span_at(r.ctx, "handoff", t_handoff, t_w0)
                    tracer.span_at(r.ctx, "answer", t_w0, t_done,
                                   replica=srv.name,
                                   n_ids=int(r.ids.size),
                                   pin_ms=round(pin_ms, 3),
                                   gather_ms=round(gather_ms, 3))
                r.t_done = t_done
                r.event.set()
                if self.taillog is not None:
                    self.taillog.offer(phases["total_ms"], {
                        "trace_id": (r.ctx.trace_id if r.ctx else None),
                        "replica": srv.name,
                        "sampled": sampled,
                        "n_ids": int(r.ids.size),
                        "staleness": staleness,
                        "phases": {k: round(v, 3)
                                   for k, v in phases.items()},
                    })
            reg.observe("frontend.dispatch_ms", (t_done - t_pickup) * 1e3,
                        replica=rlabel)
        except BaseException as e:
            self._error = e
            for r in group:
                if not r.event.is_set():
                    r.error = e
                    r.t_done = time.perf_counter()
                    reg.counter("frontend.failed")
                    r.event.set()

    def _update_loop(self):
        reg = obs.get_registry()
        servers = self.replicas + ([self.sampled_server]
                                   if self.sampled_server else [])
        try:
            while True:
                with self._apply_cond:
                    while (not self._closed
                           and self.min_applied_seq()
                           >= self.log.latest_seq):
                        self._apply_cond.wait(timeout=0.5)
                    if self._closed:
                        return
                # apply strictly one replica at a time (round-robin over
                # the fleet) so N-1 replicas always serve un-shadowed
                applied_any = False
                tracer = obs.get_tracer()
                for srv in servers:
                    for seq, add, remove, ctx in self.log.since(
                            srv.applied_seq):
                        t0 = time.perf_counter()
                        # span_in(None, ...) degrades to a fresh root span,
                        # so the apply is traced even for pre-trace entries.
                        with tracer.span_in(ctx, "apply_update",
                                            replica=srv.name, seq=seq):
                            srv.update_edges(add=add, remove=remove,
                                             seq=seq)
                        applied_any = True
                        reg.observe("frontend.rebuild_ms",
                                    (time.perf_counter() - t0) * 1e3,
                                    replica=self._replica_label(srv.name))
                        with self._apply_cond:
                            self._apply_cond.notify_all()
                if applied_any and self.sampled_server is not None:
                    # Both snapshots moved: the routing CI is stale.
                    self._probe_sampled_error()
        except BaseException as e:
            self._error = e
            with self._apply_cond:
                self._apply_cond.notify_all()

    # ------------------------------------------------------------- admin
    def stats(self) -> dict:
        servers = self.replicas + ([self.sampled_server]
                                   if self.sampled_server else [])
        return {
            "replicas": len(self.replicas),
            "max_batch": self.max_batch,
            "log_seq": self.log.latest_seq,
            "min_applied_seq": self.min_applied_seq(),
            "sampled_rel_error": (None if self.sampled_server is None
                                  else round(self.sampled_rel_error, 6)),
            "sampled_rel_ci": (None if self.sampled_server is None
                               else [round(c, 6)
                                     for c in self.sampled_rel_ci]),
            "servers": [s.stats() for s in servers],
        }

    def close(self) -> None:
        """Graceful shutdown: new submits raise, queued requests already
        in flight are answered (they precede the stop marker in queue
        order), anything racing in behind it fails fast with
        ``RuntimeError`` instead of timing out, both threads join."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(_STOP)
        with self._apply_cond:
            self._apply_cond.notify_all()
        self._dispatcher.join(timeout=5.0)
        self._updater.join(timeout=5.0)
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
