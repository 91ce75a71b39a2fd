"""Observability. Only the guarded monotonic clock is ported so far; the
metrics registry, tracer, ledger and SLO monitor are still to come."""
from repro_torch.obs.clock import GuardedClock, perf_now

__all__ = ["GuardedClock", "perf_now"]
