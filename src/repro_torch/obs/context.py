"""Explicit trace context: one causal identity per request across threads.

A copy of ``repro.obs.context``.

The :class:`~repro_torch.obs.trace.Tracer` keeps spans on per-thread stacks, so
a query that hops frontend queue → dispatcher → answer worker → client
shatters into disconnected per-thread fragments. A :class:`TraceContext`
is the explicit thread-crossing identity: ``trace_id`` names the request,
``span_id``/``parent_id`` form the span tree within it. Producers stamp a
context onto the unit of work (a ``_Request``, an ``UpdateLog`` entry, a
prefetched subgraph) and every thread that touches the work records its
spans *in* that context (``Tracer.span_in`` / ``span_at``), so the JSONL
export and the Chrome flow events can reassemble one arc per request.

Three propagation mechanisms, all explicit and allocation-cheap:

* **Carry it on the work item** — the frontend request, the update-log
  entry and the prefetch queue item each hold their context; whichever
  thread dequeues the item traces into it.
* **Thread-local current context** (``use(ctx)`` / ``current()``) —
  spans opened while a context is current automatically become children
  of it (``Tracer.span`` consults ``current()``), so nested same-thread
  instrumentation (stream layers under an update apply) joins the trace
  without any call-site changes.
* **Pending handoff** (``set_pending`` / ``take_pending``) — a
  generator-to-consumer baton: the prefetcher sets the item's context
  immediately before yielding (the yield executes on the consumer
  thread), and the engine step loop takes it right after ``next()``, so
  a training step's span links to the prefetch upload that fed it.

IDs are process-unique strings from an atomic counter (no wall clock, no
``uuid`` entropy) so traces are cheap and deterministic within a run.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading

_counter = itertools.count(1)
_prefix = f"{os.getpid() & 0xFFFF:04x}"


def _new_id() -> str:
    # itertools.count is GIL-atomic: one next() per id, no lock needed.
    return f"{_prefix}-{next(_counter):x}"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Immutable (trace_id, span_id, parent_id) triple."""

    trace_id: str
    span_id: str
    parent_id: str | None = None

    def child(self) -> "TraceContext":
        """A fresh span identity under this one, same trace."""
        return TraceContext(self.trace_id, _new_id(), self.span_id)


def new_trace() -> TraceContext:
    """Root context for a new request/update/step."""
    root = _new_id()
    return TraceContext(root, root, None)


# ----------------------------------------------------- thread-local state
_local = threading.local()


def _ctx_stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current() -> TraceContext | None:
    """The innermost context active on this thread (or None)."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


def _push(ctx: TraceContext) -> None:
    _ctx_stack().append(ctx)


def _pop() -> None:
    st = getattr(_local, "stack", None)
    if st:
        st.pop()


class use:
    """``with use(ctx): ...`` — make ``ctx`` current on this thread."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx: TraceContext | None):
        self._ctx = ctx

    def __enter__(self) -> TraceContext | None:
        if self._ctx is not None:
            _push(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> bool:
        if self._ctx is not None:
            _pop()
        return False


# ------------------------------------------------------- pending handoff
def set_pending(ctx: TraceContext | None) -> None:
    """Stash a context for the very next consumer on THIS thread (a
    generator sets it just before ``yield``; the caller takes it right
    after ``next()`` returns)."""
    _local.pending = ctx


def take_pending() -> TraceContext | None:
    """Claim (and clear) the pending context, if any."""
    ctx = getattr(_local, "pending", None)
    _local.pending = None
    return ctx
