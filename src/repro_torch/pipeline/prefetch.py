"""Double-buffered host→device subgraph loader.

The port of ``repro.pipeline.prefetch``. While the train step runs on
subgraph t, a background thread uploads subgraph t+1's block-COO tiles and
dense arrays, so host→device transfer overlaps compute. The queue depth
bounds device memory: depth 2 = classic double buffering (one batch in
compute, one in flight).

On a CUDA device the upload is asynchronous and ordered by streams, not by
the host:

* each subgraph's host arrays are copied once into pinned (page-locked)
  memory (``host_tensors(..., pin=True)``, kept in a store the caller may
  share across Prefetchers), so every later upload is a ``non_blocking``
  DMA;
* the worker thread issues the copies on its own ``torch.cuda.Stream`` and
  records an event after them; the consumer makes its current stream wait
  on that event before it hands the operands to the step, and calls
  ``record_stream`` on every uploaded tensor, so the caching allocator does
  not reuse their memory while the consumer's stream may still read them
  (after an LRU eviction or at the end of an epoch);
* a failed copy or event raises in the consumer; nothing falls back to a
  synchronous upload.

With ``enabled=False`` each upload runs on the consumer's stream and is
waited for before the step (the ablation baseline). On the CPU the same
class runs without streams or pinning.

``device_operands`` aliases the single operand pair a subgraph carries into
all four ``GraphOperands`` slots (a/at and am/amt point at the same
buffers), so GCN-family and GraphSAGE models both find their operand without
uploading anything twice.

An optional resident cache keeps up to ``resident`` subgraphs' device
operands alive across epochs — for when the whole pool fits in device
memory and re-upload, not transfer overlap, is the bottleneck.

A ``fetch(item)`` callable makes the same double buffering serve other
loaders, as in the reference: it runs on the worker thread, on the side
stream, and returns a tuple of device tensors (the streaming forward's
partition operands, ``infer/stream.py``); the event, the wait and
``record_stream`` cover every tensor of the tuple.

Observability, as in the reference: each upload is an ``upload`` span on
the uploading thread, in a trace context made per batch and left as the
consumer's pending baton just before the batch is yielded (the engine
adopts it, so a step's span and its upload's share one trace id);
``prefetch.upload_ms`` (issue to arrival on the device: the worker's time
around ``event.synchronize()``), ``prefetch.uploads``,
``prefetch.resident_hits``, ``prefetch.stall_ms`` and
``prefetch.queue_depth`` go to the metrics registry.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import OrderedDict
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.models.gnn.common import GraphOperands
from repro_torch.obs import context as trace_context
from repro_torch.pipeline.partition import HostSubgraph, SubgraphPool
from repro_torch.sparse.bcoo import BlockCOO, HostBlockCOO, host_row_ptr

_END = object()
_BCOO = ("blocks", "row_ids", "col_ids", "row_ptr")
_NODE = ("features", "labels", "train_mask", "val_mask", "test_mask")


def host_tensors(sub: HostSubgraph, pin: bool = False
                 ) -> dict[str, torch.Tensor]:
    """The subgraph's host arrays as CPU tensors, by name (``prop.blocks``,
    ``features``, …); with ``pin`` each is copied into pinned memory."""
    out: dict[str, np.ndarray] = {}
    for name in ("prop", "prop_t"):
        hb: HostBlockCOO = getattr(sub, name)
        row_ptr = (hb.row_ptr if hb.row_ptr is not None
                   else host_row_ptr(hb.row_ids, hb.n_row_blocks))
        for f, x in zip(_BCOO, (hb.blocks, hb.row_ids, hb.col_ids, row_ptr)):
            out[f"{name}.{f}"] = x
    for f in _NODE:
        out[f] = getattr(sub, f)
    if sub.loss_w is not None:
        out["loss_w"] = sub.loss_w.astype(np.float32, copy=False)
    ts = {k: torch.from_numpy(np.ascontiguousarray(x)) for k, x in out.items()}
    return {k: t.pin_memory() for k, t in ts.items()} if pin else ts


def device_operands(pool: SubgraphPool, sub: HostSubgraph,
                    device: str | torch.device = "cuda", *,
                    tensors: dict[str, torch.Tensor] | None = None
                    ) -> GraphOperands:
    """Upload one host subgraph as ``GraphOperands`` on ``device``, on the
    current stream (``non_blocking``: asynchronous from pinned
    ``tensors``, which ``host_tensors`` makes)."""
    device = torch.device(device)
    ts = tensors if tensors is not None else host_tensors(sub)
    up = {k: t.to(device, non_blocking=True) for k, t in ts.items()}

    def bcoo(name: str) -> BlockCOO:
        hb: HostBlockCOO = getattr(sub, name)
        return BlockCOO(
            blocks=up[f"{name}.blocks"], row_ids=up[f"{name}.row_ids"],
            col_ids=up[f"{name}.col_ids"], bm=hb.bm, bk=hb.bk,
            n_rows=hb.n_rows, n_cols=hb.n_cols,
            n_row_blocks=hb.n_row_blocks, n_col_blocks=hb.n_col_blocks,
            s_total=hb.s_total, row_ptr=up[f"{name}.row_ptr"],
            tile_ids=torch.arange(hb.s_total, dtype=torch.int32,
                                  device=device))

    prop, prop_t = bcoo("prop"), bcoo("prop_t")
    return GraphOperands(
        a=prop, at=prop_t, am=prop, amt=prop_t,
        **{f: up[f] for f in _NODE},
        n_valid=sub.n_valid, num_classes=pool.num_classes,
        multilabel=pool.multilabel, loss_w=up.get("loss_w"))


def operand_tensors(ops: GraphOperands) -> list[torch.Tensor]:
    """Every tensor of ``ops`` once (the aliased operand pair once)."""
    seen, out = set(), []
    for f in dataclasses.fields(ops):
        v = getattr(ops, f.name)
        vals = ([getattr(v, g) for g in (*_BCOO, "tile_ids")]
                if isinstance(v, BlockCOO) else [v])
        for t in vals:
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def _tensors_of(ops) -> list[torch.Tensor]:
    """The tensors of an upload: a subgraph's ``GraphOperands`` or a
    ``fetch`` callable's tuple."""
    if isinstance(ops, GraphOperands):
        return operand_tensors(ops)
    return [t for t in ops if isinstance(t, torch.Tensor)]


class Prefetcher:
    """Iterate ``(item, operands)`` over a schedule of pool indices, or
    of any items a ``fetch`` callable uploads (``pool`` may then be None).

    enabled=True: a daemon thread stays ``depth`` uploads ahead of the
    consumer (on CUDA, on a stream of its own). enabled=False: one
    synchronous upload per step (the ablation baseline the benchmark
    compares against).

    ``cache`` lets a caller share one resident LRU across many Prefetchers
    (train epochs and evaluation sweeps), ``pinned`` one store of pinned
    host tensors. Counters: ``uploads``, ``upload_seconds`` (issue to
    arrival on the device, on the uploading thread), ``upload_bytes``,
    ``resident_hits`` and ``stall_seconds`` (the consumer blocked waiting
    for a batch).
    """

    def __init__(
        self,
        pool: SubgraphPool,
        schedule: Sequence | Iterable,
        *,
        device: str | torch.device = "cuda",
        depth: int = 2,
        enabled: bool = True,
        resident: int = 0,
        cache: OrderedDict | None = None,
        pinned: dict | None = None,
        fetch=None,
    ):
        self.pool = pool
        self.schedule = list(schedule)
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.depth = max(1, depth)
        self.enabled = enabled
        self.upload_seconds = 0.0
        self.upload_bytes = 0
        self.uploads = 0
        self.resident_hits = 0
        self.stall_seconds = 0.0
        self._cache: OrderedDict | None = (
            cache if cache is not None
            else (OrderedDict() if resident > 0 else None))
        self._resident = resident
        self._pinned = pinned if pinned is not None else {}
        self._fetch = fetch
        self._stream: torch.cuda.Stream | None = None

    # ------------------------------------------------------------------
    def _tensors(self, sid: int) -> dict[str, torch.Tensor]:
        """The subgraph's host tensors: on CUDA its pinned copies, made on
        first use and kept in the shared store."""
        if not self.cuda:
            return host_tensors(self.pool.subgraphs[sid])
        ts = self._pinned.get(sid)
        if ts is None:
            ts = self._pinned[sid] = host_tensors(self.pool.subgraphs[sid],
                                                  pin=True)
        return ts

    def _get(self, sid, ctx: trace_context.TraceContext | None = None):
        """(operands, event) of ``sid``: a resident hit, or an upload on
        the side stream (``event`` marks its end) or, synchronously, on the
        current stream (``event`` None). ``ctx`` is the batch's trace
        context (the ``upload`` span's)."""
        reg = obs.get_registry()
        if self._cache is not None and sid in self._cache:
            self._cache.move_to_end(sid)
            self.resident_hits += 1
            reg.counter("prefetch.resident_hits")
            return self._cache[sid]
        if self._fetch is not None:
            def upload():
                return self._fetch(sid)
        else:
            sub = self.pool.subgraphs[sid]
            ts = self._tensors(sid)

            def upload():
                return device_operands(self.pool, sub, self.device,
                                       tensors=ts)
        t0 = time.perf_counter()
        event = None
        with obs.get_tracer().span_in(ctx, "upload", sub=str(sid)):
            if self.cuda and self._stream is not None:
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._stream):
                    ops = upload()
                    event = torch.cuda.Event()
                    event.record(self._stream)
                event.synchronize()
            else:
                ops = upload()
                if self.cuda:
                    torch.cuda.current_stream(self.device).synchronize()
        dt = time.perf_counter() - t0
        self.upload_seconds += dt
        self.uploads += 1
        reg.observe("prefetch.upload_ms", dt * 1e3)
        reg.counter("prefetch.uploads")
        self.upload_bytes += sum(t.numel() * t.element_size()
                                 for t in _tensors_of(ops))
        item = (ops, event)
        if self._cache is not None:
            self._cache[sid] = item
            while len(self._cache) > self._resident:
                self._cache.popitem(last=False)
        return item

    def _hand_over(self, item) -> GraphOperands:
        """Order the consumer's stream after the upload and tell the
        allocator which stream reads the uploaded tensors."""
        ops, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in _tensors_of(ops):
                t.record_stream(cur)
        return ops

    def __iter__(self) -> Iterator[tuple[int, GraphOperands]]:
        # Per-batch trace contexts: each upload gets a child of whatever
        # trace the consumer was in at iteration start (or a fresh root),
        # and the same context is left as the consumer's pending baton just
        # before the yield, so the step that uses the batch adopts it.
        tracing = obs.get_tracer().enabled
        parent = trace_context.current() if tracing else None

        def item_ctx():
            if not tracing:
                return None
            return (parent.child() if parent is not None
                    else trace_context.new_trace())

        if not self.enabled:
            for sid in self.schedule:
                ctx = item_ctx()
                got = self._get(sid, ctx)
                trace_context.set_pending(ctx)
                yield sid, self._hand_over(got)
            return

        if self.cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for sid in self.schedule:
                    if stop.is_set():
                        return
                    ctx = item_ctx()
                    if not put((sid, self._get(sid, ctx), ctx)):
                        return
            except BaseException as e:  # propagate to the consumer
                put(e)
            else:
                put(_END)

        t = threading.Thread(target=worker, daemon=True,
                             name="subgraph-prefetch")
        t.start()
        reg = obs.get_registry()
        try:
            while True:
                # Consumer-side stall: time blocked on the queue.
                t0 = time.perf_counter()
                item = q.get()
                stall = time.perf_counter() - t0
                self.stall_seconds += stall
                reg.observe("prefetch.stall_ms", stall * 1e3)
                reg.observe("prefetch.queue_depth", q.qsize())
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                sid, got, ctx = item
                trace_context.set_pending(ctx)
                yield sid, self._hand_over(got)
        finally:
            # Consumer done or aborted mid-epoch: unblock the worker and
            # drop any in-flight uploads so the thread exits promptly.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
