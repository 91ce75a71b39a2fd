"""Structured tracing: nested spans → JSONL and Chrome-trace export.

A copy of ``repro.obs.trace``.

A :class:`Tracer` records **spans** (named, timed, nested regions — the
step loop, one plan build, one partition upload) and **instants** (point
events like "refresh" or "edge-update"). Spans nest per thread; each
finished span carries its depth and parent name, so the JSONL stream is
self-describing without an object graph.

Two exports:

* ``write_jsonl(path)`` — one JSON object per line, round-trippable via
  ``read_jsonl`` (tests diff the two);
* ``export_chrome(path)`` — the Chrome Trace Event format (open in
  ``chrome://tracing`` or https://ui.perfetto.dev): spans become ``"X"``
  complete events on per-thread tracks, instants become ``"i"`` events.

**Causal arcs across threads:** ``span_in(ctx, ...)`` opens a span bound
to an explicit :class:`~repro_torch.obs.context.TraceContext`, and plain
``span(...)`` automatically joins the thread's *current* context (see
``repro_torch.obs.context``), so a request's spans share one ``trace`` id no
matter which thread records them. ``span_at(ctx, name, t0, t1)`` records
an already-elapsed interval retroactively (the dispatcher attributes a
request's queue wait after picking it up). At export time the
trace-annotated spans of each multi-thread trace are stitched into Chrome
**flow events** (``ph: "s"/"t"/"f"``) so Perfetto draws one arrowed arc
per request across the thread tracks.

Timestamps are monotonic (``perf_counter``) microseconds from the
tracer's ``origin`` (its construction or last ``reset``; the Chrome
export writes it as ``otherData.origin_perf_s``, so a device trace taken
with a host mark lines up with the spans). The event buffer is bounded
(``max_events``);
overflow drops newest events and counts them in ``dropped`` so a
truncated trace is never mistaken for a complete one.

**Device spans:** ``device_span(name, device)`` times a region on the
card: a CUDA event at each bound on the current stream, queued (from any
thread: the backward runs on autograd's) until ``resolve_device()``, which
the caller makes right after a read that synchronised. It records an
anchor event on the idle stream and takes the host time once it has
completed. When the trace is read, each pair lands on the host clock as
the anchor's host time less the pair's lead over the anchor
(:func:`device_interval`): spans ``gpu.<name>`` on a track of their own
(thread name ``device``), nested by time. Nothing is recorded,
and no event made, with tracing off, for work off a CUDA device, or while
``torch.profiler`` records (the profiler is then the device's clock).

**Crash safety:** ``install_flush(chrome=..., jsonl=...)`` registers an
atexit hook (and arms ``flush()``) so a run that dies mid-span still
writes valid output — finished spans are recorded eagerly, so the
exports are well-formed at any moment. ``flush()`` is idempotent per
install; re-installing re-arms it (a clean finalize path writes once,
the atexit backstop becomes a no-op).
"""
from __future__ import annotations

import atexit
import json
import threading

from repro_torch.obs import context as trace_context
from repro_torch.obs.clock import perf_now


class _NullSpan:
    """Reusable no-op span for a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_depth", "_parent",
                 "_ctx")

    def __init__(self, tracer: "Tracer", name: str, args: dict, ctx=None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._ctx = ctx

    def set(self, **args) -> None:
        """Attach result attributes discovered while the span is open."""
        self.args.update(args)

    def __enter__(self):
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        self._depth = len(stack)
        stack.append(self.name)
        if self._ctx is None:
            # Plain span() under an active context joins it as a child —
            # nested same-thread instrumentation needs no call changes.
            cur = trace_context.current()
            if cur is not None:
                self._ctx = cur.child()
        if self._ctx is not None:
            trace_context._push(self._ctx)
        self._t0 = perf_now()
        return self

    def __exit__(self, *exc):
        t1 = perf_now()
        self._tracer._stack().pop()
        ev = {
            "kind": "span",
            "name": self.name,
            "ts_us": round((self._t0 - self._tracer.origin) * 1e6, 1),
            "dur_us": round((t1 - self._t0) * 1e6, 1),
            "depth": self._depth,
            "parent": self._parent,
            "tid": self._tracer._tid(),
            "args": self.args,
        }
        if self._ctx is not None:
            trace_context._pop()
            ev["trace"] = self._ctx.trace_id
            ev["span"] = self._ctx.span_id
            ev["parent_span"] = self._ctx.parent_id
        self._tracer._record(ev)
        return False


class _DeviceSpan:
    """A region timed on the device by a pair of CUDA events, both on the
    stream current at its start."""

    __slots__ = ("_tracer", "name", "args", "_stream", "_start")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        import torch
        self._stream = torch.cuda.current_stream()
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record(self._stream)
        return self

    def __exit__(self, *exc):
        import torch
        end = torch.cuda.Event(enable_timing=True)
        end.record(self._stream)
        with self._tracer._lock:
            self._tracer._device.append((self.name, self.args, self._start,
                                         end))
        return False


def device_interval(start, end, anchor, t_anchor: float
                    ) -> tuple[float, float]:
    """Host-clock seconds of the device interval between events ``start``
    and ``end``, given an ``anchor`` event that completed at host time
    ``t_anchor``: each event lies ``event.elapsed_time(anchor)``
    milliseconds before it."""
    return (t_anchor - start.elapsed_time(anchor) / 1e3,
            t_anchor - end.elapsed_time(anchor) / 1e3)


class Tracer:
    """Nested-span recorder with JSONL and Chrome-trace exporters."""

    def __init__(self, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self.dropped = 0
        self.origin = perf_now()   # perf_counter seconds of ts_us 0
        self._events: list[dict] = []
        self._device: list[tuple] = []   # device spans awaiting an anchor
        self._anchored: list[tuple] = []   # (anchor, host time, spans)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: dict[int, int] = {}
        self._tid_names: dict[int, str] = {}
        self._flush_paths: tuple | None = None
        self._flushed = False
        self._atexit_armed = False

    # ------------------------------------------------------------ record
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self, key=None, name: str | None = None) -> int:
        """The track of the calling thread, or of ``key`` (named
        ``name``)."""
        key = threading.get_ident() if key is None else key
        tid = self._tids.get(key)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(key, len(self._tids))
                self._tid_names[tid] = (name if name is not None else
                                        threading.current_thread().name)
        return tid

    def _record(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def span(self, name: str, /, **args):
        """``with tracer.span("step", step=3) as sp: ... sp.set(loss=x)``"""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def span_in(self, ctx, name: str, **args):
        """Open a span bound to an explicit :class:`TraceContext` (the
        cross-thread form of ``span``): the recorded event carries the
        trace/span/parent ids and the context becomes current for the
        span's duration, so nested plain spans join the same trace.
        ``ctx=None`` degrades to ``span(name, ...)``."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args,
                     ctx=ctx.child() if ctx is not None else None)

    def span_at(self, ctx, name: str, t0: float, t1: float, **args) -> None:
        """Record an already-elapsed ``[t0, t1]`` interval (perf_counter
        seconds) as a completed span on the calling thread — used to
        attribute time retroactively (queue wait, executor handoff)."""
        if not self.enabled:
            return
        ev = {
            "kind": "span",
            "name": name,
            "ts_us": round((t0 - self.origin) * 1e6, 1),
            "dur_us": round(max(t1 - t0, 0.0) * 1e6, 1),
            "depth": 0,
            "parent": None,
            "tid": self._tid(),
            "args": args,
        }
        if ctx is not None:
            c = ctx.child()
            ev["trace"] = c.trace_id
            ev["span"] = c.span_id
            ev["parent_span"] = c.parent_id
        self._record(ev)

    def device_span(self, name: str, device, /, **args):
        """``with tracer.device_span("forward", x.device): ...`` times the
        region's work on the card as the span ``gpu.<name>``, once
        ``resolve_device`` has run. A no-op with tracing off, for a
        ``device`` that is not CUDA, or under ``torch.profiler``."""
        if not self.enabled or getattr(device, "type", None) != "cuda":
            return _NULL_SPAN
        import torch
        if torch.autograd._profiler_enabled():
            return _NULL_SPAN
        return _DeviceSpan(self, "gpu." + name, args)

    def resolve_device(self) -> int:
        """Tie the device spans queued so far to the host clock: call it
        right after a read that synchronised with the card. It records an
        anchor event on the idle stream and takes the host time once the
        anchor has completed; the spans are made from the pairs and their
        anchor when the trace is read (``snapshot`` and the exports), off
        the caller's path. Returns the number of spans anchored."""
        if not self._device:
            return 0
        import torch
        with self._lock:
            pending, self._device = self._device, []
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record()
        anchor.synchronize()
        t_anchor = perf_now()
        with self._lock:
            self._anchored.append((anchor, t_anchor, pending))
        return len(pending)

    def _materialize(self) -> None:
        """The anchored device spans as events on the ``device`` track,
        each anchor's spans nested by time."""
        with self._lock:
            batches, self._anchored = self._anchored, []
        if not batches:
            return
        tid = self._tid("device", "device")
        for anchor, t_anchor, pending in batches:
            done = []
            for name, args, start, end in pending:
                end.synchronize()
                done.append((*device_interval(start, end, anchor, t_anchor),
                             name, args))
            done.sort(key=lambda d: (d[0], -d[1]))
            stack: list[tuple[str, float]] = []
            for t0, t1, name, args in done:
                while stack and stack[-1][1] < t1:
                    stack.pop()
                self._record({
                    "kind": "span",
                    "name": name,
                    "ts_us": round((t0 - self.origin) * 1e6, 1),
                    "dur_us": round(max(t1 - t0, 0.0) * 1e6, 1),
                    "depth": len(stack),
                    "parent": stack[-1][0] if stack else None,
                    "tid": tid,
                    "args": args,
                })
                stack.append((name, t1))

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._record({
            "kind": "instant",
            "name": name,
            "ts_us": round((perf_now() - self.origin) * 1e6, 1),
            "tid": self._tid(),
            "args": args,
        })

    # ------------------------------------------------------------- reads
    def snapshot(self) -> list[dict]:
        self._materialize()
        with self._lock:
            return [dict(ev) for ev in self._events]

    def span_names(self) -> set[str]:
        self._materialize()
        with self._lock:
            return {ev["name"] for ev in self._events}

    def spans_by_trace(self) -> dict[str, list[dict]]:
        """Context-bound spans grouped by trace id, time-ordered."""
        out: dict[str, list[dict]] = {}
        for ev in self.snapshot():
            if ev["kind"] == "span" and ev.get("trace"):
                out.setdefault(ev["trace"], []).append(ev)
        for sp in out.values():
            sp.sort(key=lambda e: (e["ts_us"], e["dur_us"]))
        return out

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._device.clear()
            self._anchored.clear()
            self.dropped = 0
        self.origin = perf_now()

    # ------------------------------------------------------- crash flush
    def install_flush(self, chrome=None, jsonl=None) -> None:
        """Arm flush-on-exit: write the given trace files from ``flush()``
        or, failing that, from an atexit hook — a run that crashes
        mid-span still leaves valid (truncated-but-well-formed) output."""
        self._flush_paths = (chrome, jsonl)
        self._flushed = False
        if not self._atexit_armed:
            self._atexit_armed = True
            atexit.register(self._flush_atexit)

    def uninstall_flush(self) -> None:
        """Disarm without writing (obs.reset swaps tracers)."""
        self._flush_paths = None

    def _flush_atexit(self) -> None:
        try:
            self.flush()
        except Exception:       # never let telemetry break interpreter exit
            pass

    def flush(self) -> bool:
        """Write the installed trace files once; True if anything wrote."""
        if self._flushed or not self._flush_paths:
            return False
        chrome, jsonl = self._flush_paths
        if chrome:
            self.export_chrome(chrome)
        if jsonl:
            self.write_jsonl(jsonl)
        self._flushed = True
        return bool(chrome or jsonl)

    def flushing(self, chrome=None, jsonl=None):
        """Context manager: install on enter, flush on exit (incl. raise)."""
        return _Flushing(self, chrome, jsonl)

    # ----------------------------------------------------------- exports
    def write_jsonl(self, path) -> None:
        events = self.snapshot()
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps(ev, sort_keys=True) + "\n")

    @staticmethod
    def read_jsonl(path) -> list[dict]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def export_chrome(self, path) -> None:
        """Chrome Trace Event JSON (chrome://tracing / Perfetto)."""
        events = self.snapshot()
        with self._lock:
            tid_names = dict(self._tid_names)
        trace: list[dict] = [
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
             "args": {"name": name}}
            for tid, name in sorted(tid_names.items())
        ]
        by_trace: dict[str, list[dict]] = {}
        for ev in events:
            if ev["kind"] == "span":
                trace.append({
                    "ph": "X", "name": ev["name"], "cat": "repro",
                    "pid": 0, "tid": ev["tid"],
                    "ts": ev["ts_us"], "dur": ev["dur_us"],
                    "args": ev["args"],
                })
                if ev.get("trace"):
                    by_trace.setdefault(ev["trace"], []).append(ev)
            else:
                trace.append({
                    "ph": "i", "name": ev["name"], "cat": "repro",
                    "pid": 0, "tid": ev["tid"], "ts": ev["ts_us"],
                    "s": "t", "args": ev["args"],
                })
        # Flow events: one causal arc per multi-thread trace. The arc
        # enters each span just inside its start so the viewer binds it
        # to the enclosing slice on that thread's track.
        for trace_id, sp in sorted(by_trace.items()):
            if len({e["tid"] for e in sp}) < 2:
                continue
            sp.sort(key=lambda e: (e["ts_us"], e["dur_us"]))
            last = len(sp) - 1
            for i, e in enumerate(sp):
                ph = "s" if i == 0 else ("f" if i == last else "t")
                rec = {
                    "ph": ph, "name": "request", "cat": "flow",
                    "id": trace_id, "pid": 0, "tid": e["tid"],
                    "ts": round(e["ts_us"] + min(e["dur_us"], 1.0) / 2, 1),
                }
                if ph == "f":
                    rec["bp"] = "e"
                trace.append(rec)
        with open(path, "w") as f:
            json.dump({"traceEvents": trace, "displayTimeUnit": "ms",
                       "otherData": {"dropped_events": self.dropped,
                                     "origin_perf_s": self.origin}}, f)


class _Flushing:
    """``with tracer.flushing(chrome=..., jsonl=...):`` crash-safe scope."""

    def __init__(self, tracer: Tracer, chrome, jsonl):
        self._tracer = tracer
        self._paths = (chrome, jsonl)

    def __enter__(self) -> Tracer:
        self._tracer.install_flush(*self._paths)
        return self._tracer

    def __exit__(self, *exc) -> bool:
        self._tracer.flush()
        return False
