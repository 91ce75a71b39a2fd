"""Slowest-K request reservoir: keep the tail, drop the bulk.

A copy of ``repro.obs.taillog``.

p99 attribution needs the *individual* worst requests, not another
histogram — "why was this query slow" is answered by its span tree, and
keeping every request's tree is exactly the overhead tracing must avoid.
:class:`TailLog` is a bounded min-heap keyed on total latency: offering
is O(log K) and the K slowest requests seen so far survive, each with its
full phase breakdown and span tree. The serving frontend offers every
answered request; ``MetricsExporter`` serves the reservoir at
``/debug/slow``.

Records are plain dicts (JSON-ready); the heap never stores more than
``k`` of them, so an unbounded query stream costs O(K) memory.
"""
from __future__ import annotations

import heapq
import threading


class TailLog:
    """Thread-safe slowest-K reservoir of request records."""

    def __init__(self, k: int = 16):
        self.k = int(k)
        self.offered = 0
        self._lock = threading.Lock()
        # (total_ms, tiebreak, record): heap[0] is the FASTEST kept
        # request — the one the next slower offer evicts.
        self._heap: list[tuple[float, int, dict]] = []
        self._seq = 0

    def offer(self, total_ms: float, record: dict) -> bool:
        """Consider one finished request; True if it entered the tail."""
        total_ms = float(total_ms)
        with self._lock:
            self.offered += 1
            self._seq += 1
            item = (total_ms, self._seq, record)
            if len(self._heap) < self.k:
                heapq.heappush(self._heap, item)
                return True
            if total_ms > self._heap[0][0]:
                heapq.heapreplace(self._heap, item)
                return True
            return False

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def threshold_ms(self) -> float | None:
        """Latency a request must beat to enter a full reservoir."""
        with self._lock:
            if len(self._heap) < self.k:
                return None
            return self._heap[0][0]

    def snapshot(self) -> dict:
        """JSON-ready view, slowest request first."""
        with self._lock:
            items = sorted(self._heap, key=lambda it: -it[0])
            return {
                "k": self.k,
                "offered": self.offered,
                "kept": len(items),
                "slow": [dict(rec, total_ms=round(ms, 3))
                         for ms, _, rec in items],
            }

    def clear(self) -> None:
        with self._lock:
            self._heap.clear()
            self.offered = 0
