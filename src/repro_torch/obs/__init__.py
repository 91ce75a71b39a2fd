"""Observability. The guarded monotonic clock is ported; the ledger is a
hook with no effect (``obs.ledger``); the metrics registry, tracer and SLO
monitor are still to come."""
from repro_torch.obs.clock import GuardedClock, perf_now
from repro_torch.obs.ledger import get_ledger

__all__ = ["GuardedClock", "get_ledger", "perf_now"]
