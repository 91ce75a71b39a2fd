"""Process-wide metrics registry: counters, gauges, timing histograms.

A copy of ``repro.obs.registry``.

One instrument per ``(name, labels)`` pair — labels are small static
dimensions like the layer index, shape bucket or shard, never per-node
ids. Three kinds:

* **counter** — monotone float, ``counter("prefetch.uploads")``;
* **gauge** — last-write-wins float, ``gauge("rsc.flops_fraction", 0.1)``;
* **histogram** — a stream of observations (typically milliseconds) with
  exact count/sum/min/max and p50/p95/p99 quantiles over a bounded
  reservoir (the newest ``max_samples`` observations; long runs report
  recent-window quantiles, which is what a latency dashboard wants).

Everything is guarded by one lock, so the prefetch thread and the train
loop can record concurrently. A disabled registry is a cheap no-op (one
attribute check per call) — the overhead benchmark compares the two modes.

``snapshot()`` renders the whole registry to a JSON-ready dict for tests
and CLI dumps; keys are ``name{k=v,...}`` with labels sorted.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from repro_torch.obs.clock import perf_now


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Histogram:
    __slots__ = ("count", "total", "vmin", "vmax", "samples", "_cap", "_pos")

    def __init__(self, cap: int):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: list[float] = []
        self._cap = cap
        self._pos = 0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if len(self.samples) < self._cap:
            self.samples.append(v)
        else:  # ring buffer: quantiles cover the newest cap observations
            self.samples[self._pos] = v
            self._pos = (self._pos + 1) % self._cap

    def quantile(self, q: float) -> float:
        s = sorted(self.samples)
        if not s:
            return float("nan")
        idx = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
        return s[idx]

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / max(self.count, 1),
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "p50": self.quantile(0.50) if self.count else None,
            "p95": self.quantile(0.95) if self.count else None,
            "p99": self.quantile(0.99) if self.count else None,
        }


class MetricsRegistry:
    """Counters / gauges / histograms behind one lock and an enable flag."""

    def __init__(self, enabled: bool = True, max_samples: int = 4096):
        self.enabled = enabled
        self.max_samples = max_samples
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Histogram] = {}

    # ------------------------------------------------------------- write
    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        if not self.enabled:
            return
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        k = _key(name, labels)
        with self._lock:
            self._gauges[k] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Histogram(self.max_samples)
            h.observe(float(value))

    @contextmanager
    def timer(self, name: str, **labels):
        """Time a block and observe milliseconds into ``name``."""
        if not self.enabled:
            yield
            return
        t0 = perf_now()
        try:
            yield
        finally:
            self.observe(name, (perf_now() - t0) * 1e3, **labels)

    # -------------------------------------------------------------- read
    def get_counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def get_gauge(self, name: str, **labels) -> float | None:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def get_histogram(self, name: str, **labels) -> dict | None:
        with self._lock:
            h = self._hists.get(_key(name, labels))
            return h.summary() if h is not None else None

    def snapshot(self) -> dict:
        """JSON-ready dump of every instrument."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary()
                               for k, h in self._hists.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def snapshot_delta(before: dict, after: dict) -> dict:
    """Per-instrument increments between two ``snapshot()`` dicts.

    Lets a test assert "this step incremented counter X by 2 and added 3
    histogram observations" WITHOUT ``reset()``-ing the process-wide
    registry out from under concurrently-running code. Counters report
    ``after - before`` (new keys count from 0); gauges report keys whose
    value changed (new value); histograms report count/sum deltas for
    keys with new observations.
    """
    counters = {}
    for k, v in after.get("counters", {}).items():
        dv = v - before.get("counters", {}).get(k, 0.0)
        if dv:
            counters[k] = dv
    gauges = {k: v for k, v in after.get("gauges", {}).items()
              if before.get("gauges", {}).get(k) != v}
    hists = {}
    for k, h in after.get("histograms", {}).items():
        prev = before.get("histograms", {}).get(k)
        dc = h["count"] - (prev["count"] if prev else 0)
        if dc:
            hists[k] = {"count": dc,
                        "sum": h["sum"] - (prev["sum"] if prev else 0.0)}
    return {"counters": counters, "gauges": gauges, "histograms": hists}
