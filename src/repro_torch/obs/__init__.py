"""Unified telemetry: metrics registry, tracer, approximation ledger.

The port of ``repro.obs`` (framework-free Python, copied, not imported).
One process-wide :class:`Observability` bundle holds a
:class:`~repro_torch.obs.registry.MetricsRegistry`, a
:class:`~repro_torch.obs.trace.Tracer` and a
:class:`~repro_torch.obs.ledger.ApproxLedger`, each independently
enable-able:

    from repro_torch import obs
    obs.configure(metrics=True, trace=True, ledger=True)
    ...
    obs.get_registry().snapshot()
    obs.get_tracer().export_chrome("trace.json")
    obs.get_ledger().snapshot()

All default to DISABLED — every instrumentation site in the engine,
pipeline, kernels and serving layers checks one attribute and returns.
Tests swap a fresh bundle in via :func:`reset`.

``--metrics-port N`` (see :func:`add_cli_flags`) additionally starts the
background HTTP exposition endpoint (:mod:`repro_torch.obs.export`)
serving the live registry + ledger as Prometheus text and JSON while the
run is in flight; it implies ``--metrics`` and enables the ledger.

The reference's compile sentinel (``obs.sentinel``, ``--strict-compiles``)
has no counterpart: the port runs eagerly and builds its kernels once, so
there is no recompile to count. The slow-request ``TailLog`` comes with
the serving frontend (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

from repro_torch.obs.clock import GuardedClock, perf_now
from repro_torch.obs.context import TraceContext, new_trace
from repro_torch.obs.ledger import ApproxLedger, BudgetError
from repro_torch.obs.registry import MetricsRegistry, snapshot_delta
from repro_torch.obs.slo import SLOError, SLOMonitor
from repro_torch.obs.trace import Tracer

__all__ = [
    "ApproxLedger", "BudgetError", "GuardedClock", "MetricsRegistry",
    "Observability", "SLOError", "SLOMonitor", "TraceContext", "Tracer",
    "add_cli_flags", "configure", "finalize_from_args", "get_ledger",
    "get_obs", "get_registry", "get_tracer", "new_trace", "perf_now",
    "reset", "setup_from_args", "snapshot_delta",
]


class Observability:
    """A registry + tracer + ledger triple sharing one lifecycle."""

    def __init__(self, metrics: bool = False, trace: bool = False,
                 ledger: bool = False):
        self.registry = MetricsRegistry(enabled=metrics)
        self.tracer = Tracer(enabled=trace)
        self.ledger = ApproxLedger(enabled=ledger)
        self.exporter = None   # MetricsExporter when --metrics-port is up

    @property
    def enabled(self) -> bool:
        return (self.registry.enabled or self.tracer.enabled
                or self.ledger.enabled)


_obs = Observability()


def get_obs() -> Observability:
    return _obs


def get_registry() -> MetricsRegistry:
    return _obs.registry


def get_tracer() -> Tracer:
    return _obs.tracer


def get_ledger() -> ApproxLedger:
    return _obs.ledger


def configure(metrics: bool | None = None,
              trace: bool | None = None,
              ledger: bool | None = None) -> Observability:
    """Flip the process-wide enable flags (None = leave as is)."""
    if metrics is not None:
        _obs.registry.enabled = bool(metrics)
    if trace is not None:
        _obs.tracer.enabled = bool(trace)
    if ledger is not None:
        _obs.ledger.enabled = bool(ledger)
    return _obs


def reset(metrics: bool = False, trace: bool = False,
          ledger: bool = False) -> Observability:
    """Swap in a fresh bundle (tests; also clears all recorded data)."""
    global _obs
    _obs.tracer.uninstall_flush()   # old bundle must not write at exit
    if _obs.exporter is not None:
        _obs.exporter.close()
    _obs = Observability(metrics=metrics, trace=trace, ledger=ledger)
    return _obs


# ------------------------------------------------------------------ CLI
def add_cli_flags(parser) -> None:
    """Attach the standard observability flags to an argparse parser."""
    parser.add_argument("--metrics", action="store_true",
                        help="enable the metrics registry and include its "
                             "snapshot in the result JSON")
    parser.add_argument("--metrics-port", type=int, default=None,
                        metavar="PORT",
                        help="serve live Prometheus-text + JSON metrics on "
                             "this port while the run is in flight "
                             "(implies --metrics; 0 = ephemeral port); "
                             "also enables the approximation ledger")
    parser.add_argument("--trace-out", default=None, metavar="PATH",
                        help="enable tracing; write a Chrome-trace JSON "
                             "(open at ui.perfetto.dev or chrome://tracing)")
    parser.add_argument("--trace-jsonl", default=None, metavar="PATH",
                        help="enable tracing; write raw span records as "
                             "JSONL (one event per line)")


def setup_from_args(args) -> Observability:
    """Flip the process-wide flags from parsed ``add_cli_flags`` args;
    start the exposition endpoint and arm crash-safe trace flushing."""
    port = getattr(args, "metrics_port", None)
    metrics = bool(args.metrics or port is not None)
    ob = configure(metrics=metrics,
                   trace=bool(args.trace_out or args.trace_jsonl),
                   ledger=metrics)
    if args.trace_out or args.trace_jsonl:
        # Armed NOW, not at finalize: a crash mid-run still writes traces.
        ob.tracer.install_flush(chrome=args.trace_out,
                                jsonl=args.trace_jsonl)
    if port is not None:
        from repro_torch.obs.export import MetricsExporter
        ob.exporter = MetricsExporter(port=port, registry=ob.registry,
                                      ledger=ob.ledger)
        print(f"[obs] metrics exposition at {ob.exporter.url}/metrics")
    return ob


def finalize_from_args(args) -> dict | None:
    """Write the requested trace files, stop the exposition endpoint;
    return the metrics snapshot (``None`` when metrics were off)."""
    if args.trace_out or args.trace_jsonl:
        _obs.tracer.install_flush(chrome=args.trace_out,
                                  jsonl=args.trace_jsonl)
        _obs.tracer.flush()
    if _obs.exporter is not None:
        _obs.exporter.close()
        _obs.exporter = None
    return _obs.registry.snapshot() if _obs.registry.enabled else None
