"""Fault-tolerance policies: heartbeats and straggler mitigation.

A copy of ``repro.distributed.fault`` (pure host logic). The failure
model: (a) hard loss of a rank, detected by missed heartbeats and handled
by a restart from the latest checkpoint; (b) stragglers, detected as
step-time outliers against an EWMA baseline, recommended for eviction
before they become hard failures (slow memory, thermal throttling).

The policies are transport-agnostic: a launcher wires heartbeats to
whatever control plane exists; the tests drive them with synthetic
timelines.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class HeartbeatTracker:
    """Declares a worker dead after ``timeout_s`` without a heartbeat."""

    n_workers: int
    timeout_s: float = 60.0

    def __post_init__(self):
        now = time.monotonic()
        self.last_seen = {w: now for w in range(self.n_workers)}

    def beat(self, worker: int, now: float | None = None) -> None:
        self.last_seen[worker] = now if now is not None else time.monotonic()

    def dead(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.monotonic()
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout_s]


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time outlier detection per worker.

    A worker is a straggler when its step-time EWMA exceeds ``threshold ×
    median-of-EWMAs`` for ``patience`` consecutive steps.
    """

    n_workers: int
    alpha: float = 0.2
    threshold: float = 2.0
    patience: int = 3

    def __post_init__(self):
        self.ewma = [None] * self.n_workers
        self.strikes = [0] * self.n_workers

    def observe(self, step_times: list[float]) -> list[int]:
        """Feed one step's per-worker times; returns eviction candidates."""
        for w, t in enumerate(step_times):
            self.ewma[w] = t if self.ewma[w] is None else \
                (1 - self.alpha) * self.ewma[w] + self.alpha * t
        vals = sorted(e for e in self.ewma if e is not None)
        med = vals[len(vals) // 2]
        out = []
        for w in range(self.n_workers):
            if self.ewma[w] is not None and self.ewma[w] > \
                    self.threshold * med:
                self.strikes[w] += 1
            else:
                self.strikes[w] = 0
            if self.strikes[w] >= self.patience:
                out.append(w)
        return out


@dataclasses.dataclass
class RestartPolicy:
    """Decides the restart strategy after failures (for the launcher)."""

    min_workers: int

    def plan(self, alive: int, total: int) -> str:
        if alive == total:
            return "continue"
        if alive >= self.min_workers:
            # elastic shrink: restart from the checkpoint on fewer ranks
            return "shrink"
        return "halt"
