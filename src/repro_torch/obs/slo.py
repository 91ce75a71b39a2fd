"""Declarative SLOs over the live registry, with burn-rate alerting.

A copy of ``repro.obs.slo``.

The registry already exports every signal a serving objective needs —
request latency histograms, the sampled-error confidence bound, replica
staleness, drop/failure counters. Nothing watched them. An
:class:`SLOMonitor` holds declarative objectives (``{"p99_ms": 50.0}``),
evaluates them from registry snapshots on every ``tick()``, and keeps a
bounded history of timestamped violation verdicts from which it computes
**multi-window burn rates**: for each window, the fraction of recent
ticks in violation divided by the allowed error budget
(``budget_frac``). An objective *alerts* only when every window burns at
or above ``burn_threshold`` — the standard fast+slow-window rule: the
short window makes alerts prompt, the long window makes them ignore
single-tick blips.

Objectives (targets via ``--slo key=value``):

* ``p99_ms``     — p99 request latency (frontend, else serve/engine) ≤
* ``error_ci``   — sampled replica's upper CI relative error ≤
* ``staleness``  — max replica lag behind the update log (entries) ≤
* ``availability`` — answered / submitted requests ≥

State is exposed three ways: ``rsc_slo_*`` gauges published into the
registry on each tick (scrapeable at ``/metrics``), the ``/slo`` JSON
endpoint on :class:`~repro_torch.obs.export.MetricsExporter`, and
``check(hard_fail=True)`` raising :class:`SLOError` — the ``--strict-slo``
counterpart of ``--strict-budget``.

``self_test()`` proves the alerting path end-to-end on synthetic data:
an impossible objective must alert, a trivially-satisfied one must not.
Its verdict ships in every ``report()`` so a dashboard showing "no
alerts" is distinguishable from "alerting is broken".
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from repro_torch.obs.export import _parse_key

__all__ = ["SLOError", "SLOMonitor", "Objective", "SPECS",
           "add_cli_flags", "monitor_from_args", "parse_targets"]


class SLOError(RuntimeError):
    """--strict-slo: an objective's burn rate alerted."""


@dataclasses.dataclass(frozen=True)
class Objective:
    key: str
    target: float
    kind: str          # "hist_p99" | "gauge_max" | "availability"
    metrics: tuple     # candidate metric names, first with data wins
    cmp: str           # "le" (value must stay <= target) | "ge"


# Declarative objective specs: how each key reads the registry.
SPECS: dict[str, tuple[str, tuple, str]] = {
    "p99_ms": ("hist_p99",
               ("frontend.request_ms", "serve.query_ms", "engine.step_ms"),
               "le"),
    "error_ci": ("gauge_max",
                 ("frontend.sampled_rel_ci_hi", "rsc.probe.rel_err_hi"),
                 "le"),
    "staleness": ("gauge_max", ("frontend.staleness",), "le"),
    "availability": ("availability", (), "ge"),
}


def parse_targets(specs) -> dict[str, float]:
    """``["p99_ms=50", "availability=0.99"]`` → validated target dict."""
    out: dict[str, float] = {}
    for spec in specs or ():
        key, sep, val = str(spec).partition("=")
        key = key.strip()
        if not sep or key not in SPECS:
            raise ValueError(
                f"--slo wants KEY=TARGET with KEY in {sorted(SPECS)}, "
                f"got {spec!r}")
        out[key] = float(val)
    return out


def _series(section: dict, metric: str) -> list:
    """All values of one metric name across its label combinations."""
    return [v for k, v in section.items() if _parse_key(k)[0] == metric]


def _eval_objective(obj: Objective, snap: dict) -> float | None:
    """Objective's current value from a registry snapshot (None = no
    data yet — not a violation, flagged ``no_data`` in reports)."""
    if obj.kind == "hist_p99":
        for metric in obj.metrics:
            vals = [h.get("p99") for h in
                    _series(snap.get("histograms", {}), metric)]
            vals = [v for v in vals if v is not None]
            if vals:
                return float(max(vals))
        return None
    if obj.kind == "gauge_max":
        for metric in obj.metrics:
            vals = _series(snap.get("gauges", {}), metric)
            if vals:
                return float(max(vals))
        return None
    # availability: answered / submitted, from frontend counters.
    counters = snap.get("counters", {})
    total = sum(_series(counters, "frontend.requests"))
    if total <= 0:
        return None
    bad = (sum(_series(counters, "frontend.deadline_dropped"))
           + sum(_series(counters, "frontend.failed")))
    return float(1.0 - bad / total)


class SLOMonitor:
    """Evaluate objectives from registry snapshots; alert on burn rate."""

    def __init__(self, targets: dict[str, float], *, registry=None,
                 windows: tuple = (30.0, 300.0), budget_frac: float = 0.05,
                 burn_threshold: float = 1.0, max_ticks: int = 4096,
                 gauge_prefix: str = "rsc.slo"):
        if not targets:
            raise ValueError("SLOMonitor needs at least one objective")
        self.objectives = []
        for key, target in targets.items():
            kind, metrics, cmp = SPECS[key]
            self.objectives.append(Objective(key, float(target), kind,
                                             metrics, cmp))
        self._registry = registry
        self.windows = tuple(float(w) for w in windows)
        self.budget_frac = float(budget_frac)
        self.burn_threshold = float(burn_threshold)
        self.gauge_prefix = gauge_prefix
        self._lock = threading.Lock()
        # (t, {key: violated-bool-or-None}) — bounded tick history.
        self._ticks: deque = deque(maxlen=int(max_ticks))
        self._last: dict[str, dict] = {}
        self._ticker: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ evaluate
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from repro_torch import obs
        return obs.get_registry()

    def tick(self, snapshot: dict | None = None,
             now: float | None = None) -> dict:
        """Evaluate every objective once; record verdicts; publish gauges."""
        reg = self._reg()
        snap = snapshot if snapshot is not None else reg.snapshot()
        now = time.monotonic() if now is None else float(now)
        verdicts: dict[str, bool | None] = {}
        evals: dict[str, dict] = {}
        for obj in self.objectives:
            value = _eval_objective(obj, snap)
            if value is None:
                violated = None
            elif obj.cmp == "le":
                violated = value > obj.target
            else:
                violated = value < obj.target
            verdicts[obj.key] = violated
            evals[obj.key] = {"value": value, "target": obj.target,
                              "cmp": obj.cmp,
                              "ok": (violated is not True),
                              "no_data": value is None}
        with self._lock:
            self._ticks.append((now, verdicts))
            self._last = evals
        self._publish(reg, evals, now)
        return evals

    def burn_rates(self, key: str, now: float | None = None) -> dict:
        """Per-window burn rate: violating-tick fraction / budget_frac."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            ticks = list(self._ticks)
        out: dict[str, float | None] = {}
        for w in self.windows:
            seen = [v[key] for t, v in ticks
                    if t >= now - w and v.get(key) is not None]
            if not seen:
                out[f"{w:g}s"] = None
                continue
            frac = sum(1 for v in seen if v) / len(seen)
            out[f"{w:g}s"] = frac / max(self.budget_frac, 1e-9)
        return out

    def alerts(self, now: float | None = None) -> list[str]:
        """Objectives whose burn rate meets the threshold in EVERY window."""
        now = time.monotonic() if now is None else float(now)
        out = []
        for obj in self.objectives:
            rates = self.burn_rates(obj.key, now=now).values()
            if rates and all(r is not None and r >= self.burn_threshold
                             for r in rates):
                out.append(obj.key)
        return out

    def _publish(self, reg, evals: dict, now: float) -> None:
        if not getattr(reg, "enabled", False):
            return
        p = self.gauge_prefix
        alerting = set(self.alerts(now=now))
        for key, ev in evals.items():
            if ev["value"] is not None:
                reg.gauge(f"{p}.value", ev["value"], slo=key)
            reg.gauge(f"{p}.target", ev["target"], slo=key)
            reg.gauge(f"{p}.ok", 0.0 if ev["ok"] is False else 1.0, slo=key)
            reg.gauge(f"{p}.alert", 1.0 if key in alerting else 0.0,
                      slo=key)
            for wname, rate in self.burn_rates(key, now=now).items():
                if rate is not None:
                    reg.gauge(f"{p}.burn_rate", rate, slo=key,
                              window=wname)

    # ------------------------------------------------------------- report
    def report(self, snapshot: dict | None = None) -> dict:
        """JSON-ready state for ``/slo``: one fresh tick + burn history."""
        self.tick(snapshot=snapshot)
        now = time.monotonic()
        with self._lock:
            last = {k: dict(v) for k, v in self._last.items()}
            n_ticks = len(self._ticks)
        alerting = self.alerts(now=now)
        objectives = {}
        for obj in self.objectives:
            objectives[obj.key] = dict(
                last.get(obj.key, {}),
                burn_rates=self.burn_rates(obj.key, now=now),
                alert=obj.key in alerting)
        return {
            "objectives": objectives,
            "alerts": alerting,
            "windows_s": list(self.windows),
            "budget_frac": self.budget_frac,
            "burn_threshold": self.burn_threshold,
            "ticks": n_ticks,
            "self_test": self.self_test(),
        }

    def check(self, where: str = "", hard_fail: bool = False) -> list[str]:
        """Return alerting objectives; raise :class:`SLOError` if strict."""
        alerting = self.alerts()
        if alerting and hard_fail:
            detail = ", ".join(
                f"{k}={self._last.get(k, {}).get('value')}"
                f" (target {self._last.get(k, {}).get('target')})"
                for k in alerting)
            raise SLOError(
                f"SLO burn-rate alert{f' at {where}' if where else ''}: "
                f"{detail}")
        return alerting

    # ----------------------------------------------------- injected proof
    @staticmethod
    def self_test() -> dict:
        """Injected-violation proof that the burn-rate path alerts.

        Builds a private monitor over synthetic snapshots where ``p99_ms``
        is impossibly strict (must alert) and ``staleness`` is trivially
        loose (must not); feeds enough ticks to cover both windows.
        """
        mon = SLOMonitor({"p99_ms": 0.001, "staleness": 1e9},
                         registry=_NullRegistry(), windows=(5.0, 30.0),
                         budget_frac=0.05)
        snap = {"counters": {}, "gauges": {"frontend.staleness": 1.0},
                "histograms": {"frontend.request_ms": {
                    "count": 10, "sum": 50.0, "p99": 5.0}}}
        for i in range(8):
            mon.tick(snapshot=snap, now=float(i * 5))
        alerting = mon.alerts(now=35.0)
        return {
            "pass": alerting == ["p99_ms"],
            "alerted": alerting,
            "burn": mon.burn_rates("p99_ms", now=35.0),
        }

    # ---------------------------------------------------- background tick
    def start(self, period: float = 1.0) -> None:
        """Tick from a daemon thread (live /slo + gauges during a run)."""
        if self._ticker is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(period):
                try:
                    self.tick()
                except Exception:   # telemetry must never kill the run
                    pass

        self._ticker = threading.Thread(target=loop, daemon=True,
                                        name="slo-monitor")
        self._ticker.start()

    def stop(self) -> None:
        if self._ticker is None:
            return
        self._stop.set()
        self._ticker.join(timeout=5.0)
        self._ticker = None


class _NullRegistry:
    """Self-test sink: never publishes, never reads the process registry."""

    enabled = False

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def gauge(self, *a, **k) -> None:
        pass


# ---------------------------------------------------------------- CLI glue
def add_cli_flags(parser) -> None:
    parser.add_argument("--slo", action="append", default=[],
                        metavar="KEY=TARGET",
                        help="declare a serving objective "
                             f"(keys: {', '.join(sorted(SPECS))}); "
                             "repeatable; evaluated from live registry "
                             "snapshots with multi-window burn-rate "
                             "alerts, served at /slo and as rsc_slo_* "
                             "gauges")
    parser.add_argument("--strict-slo", action="store_true",
                        help="hard-fail (SLOError) at finalize when any "
                             "declared SLO's burn rate alerts")


def monitor_from_args(args, registry=None) -> SLOMonitor | None:
    """Build (and start ticking) a monitor from parsed ``--slo`` flags."""
    targets = parse_targets(getattr(args, "slo", None))
    if not targets:
        if getattr(args, "strict_slo", False):
            raise SystemExit("--strict-slo needs at least one --slo "
                             "KEY=TARGET objective")
        return None
    return SLOMonitor(targets, registry=registry)
