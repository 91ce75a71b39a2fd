"""Monotonic time helpers (a copy of ``repro.obs.clock``).

Every duration comes from a monotonic clock (``time.perf_counter``), never
wall-clock ``time.time()``: NTP steps and DST changes make wall-clock deltas
go negative or jump hours. ``GuardedClock`` adds a second belt: even if a
platform's monotonic source misbehaves, elapsed times are clamped to ≥ 0 and
the clamp is counted so the corruption is visible instead of silent.
"""
from __future__ import annotations

import time

perf_now = time.perf_counter


class GuardedClock:
    """Monotonic stopwatch whose elapsed times can never go negative.

    ``anomalies`` counts clamped (would-be-negative) deltas — any nonzero
    value means the underlying clock source is broken on this host.
    """

    def __init__(self, now=perf_now):
        self._now = now
        self.anomalies = 0

    def now(self) -> float:
        return self._now()

    def elapsed(self, t0: float) -> float:
        dt = self._now() - t0
        if dt < 0.0:
            self.anomalies += 1
            return 0.0
        return dt
