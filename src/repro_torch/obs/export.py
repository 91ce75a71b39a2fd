"""Live metrics exposition: a zero-dependency background HTTP endpoint.

A copy of ``repro.obs.export``.

Serves the process-wide registry + approximation ledger while a run is
in flight (``--metrics-port``):

* ``GET /metrics`` — Prometheus text exposition format 0.0.4
  (``text/plain; version=0.0.4; charset=utf-8``): counters and gauges as
  typed samples, histograms as summaries (p50/p95/p99 quantiles + _sum +
  _count). Registry keys like ``rsc.ledger.realized_tiles{layer=gcn/spmm0}``
  become ``rsc_ledger_realized_tiles{layer="gcn/spmm0"}`` — names are
  sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*``, label values are escaped per
  the format spec (backslash, double-quote, newline).
* ``GET /metrics.json`` — the raw registry snapshot + ledger snapshot as
  one JSON document (dashboards, tests, jq).
* ``GET /slo`` — the attached :class:`~repro_torch.obs.slo.SLOMonitor`'s
  report: per-objective value/target/burn-rates/alert plus the
  injected-violation self-test verdict (404 when none attached).
* ``GET /debug/slow`` — the attached tail log's (anything with a
  ``snapshot()``; the serving frontend's ``TailLog``, ROADMAP.md Queue 1
  item 7): the K slowest requests with phase breakdowns and span trees
  (404 when none attached).
* ``GET /healthz`` — liveness.

Built on :class:`http.server.ThreadingHTTPServer` (stdlib only), serving
from a daemon thread; ``port=0`` binds an ephemeral port exposed via
``.port`` so tests never collide.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
# DOTALL: label VALUES may contain newlines (escaped on render, not here).
_KEY_RE = re.compile(r"^(?P<name>[^{]+)(\{(?P<labels>.*)\})?$", re.DOTALL)


def _prom_name(name: str) -> str:
    s = _NAME_BAD.sub("_", name)
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _parse_key(key: str) -> tuple[str, dict[str, str]]:
    """Split a registry key ``name{k=v,...}`` back into name + labels."""
    m = _KEY_RE.match(key)
    if m is None:               # pathological key: expose it un-labelled
        return key, {}
    name = m.group("name")
    labels: dict[str, str] = {}
    raw = m.group("labels")
    if raw:
        for part in raw.split(","):
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if f != f:
        return "NaN"
    return repr(f)


def render_prometheus(snapshot: dict, ledger_snapshot: dict | None = None
                      ) -> str:
    """Registry snapshot (+ ledger totals) → Prometheus text format.

    Samples are grouped into metric FAMILIES keyed by the sanitized name:
    the spec requires exactly one ``# TYPE`` line per family, emitted
    before any of its samples, with all of the family's samples
    contiguous. Sanitization can collide distinct registry names
    (``a.b`` and ``a_b``) — a collision across instrument kinds demotes
    the family to untyped (no TYPE line, still legal), and duplicate
    ``(name, labels)`` samples within a family are dropped after the
    first so a scrape never sees the same series twice. Histograms render
    as summaries: ``quantile``-labeled samples on the base name plus
    ``_sum``/``_count`` series per labelset (empty reservoirs quote their
    quantiles as ``NaN``, the spec's empty-summary value).
    """
    snap = snapshot or {"counters": {}, "gauges": {}, "histograms": {}}
    # family name → {"kind": str, "samples": [(suffix, labels, value)]}
    families: dict[str, dict] = {}

    def family(pname: str, kind: str) -> dict:
        fam = families.get(pname)
        if fam is None:
            fam = families[pname] = {"kind": kind, "samples": []}
        elif fam["kind"] != kind:
            fam["kind"] = "untyped"
        return fam

    for key, val in sorted(snap.get("counters", {}).items()):
        name, labels = _parse_key(key)
        family(_prom_name(name), "counter")["samples"].append(
            ("", labels, _fmt_value(val)))
    for key, val in sorted(snap.get("gauges", {}).items()):
        name, labels = _parse_key(key)
        family(_prom_name(name), "gauge")["samples"].append(
            ("", labels, _fmt_value(val)))
    for key, h in sorted(snap.get("histograms", {}).items()):
        name, labels = _parse_key(key)
        fam = family(_prom_name(name), "summary")
        for q, field in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            fam["samples"].append(
                ("", dict(labels, quantile=q), _fmt_value(h.get(field))))
        fam["samples"].append(("_sum", labels, _fmt_value(h["sum"])))
        fam["samples"].append(("_count", labels, _fmt_value(h["count"])))

    if ledger_snapshot is not None and ledger_snapshot.get("enabled"):
        family("rsc_ledger_epochs_total", "counter")["samples"].append(
            ("", {}, str(float(len(ledger_snapshot["epochs"])))))
        family("rsc_ledger_alloc_violations_total", "counter")[
            "samples"].append(
            ("", {}, str(float(ledger_snapshot["violations"]))))

    lines: list[str] = []
    for pname, fam in families.items():
        if fam["kind"] != "untyped":
            lines.append(f"# TYPE {pname} {fam['kind']}")
        seen: set[tuple[str, str]] = set()
        for suffix, labels, val in fam["samples"]:
            lbl = _fmt_labels(labels)
            if (suffix, lbl) in seen:
                continue
            seen.add((suffix, lbl))
            lines.append(f"{pname}{suffix}{lbl} {val}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "rsc-metrics/1"

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):   # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        registry = self.server.registry        # type: ignore[attr-defined]
        ledger = self.server.ledger            # type: ignore[attr-defined]
        if path in ("/", "/metrics"):
            snap = registry.snapshot() if registry is not None else None
            led = ledger.snapshot() if ledger is not None else None
            body = render_prometheus(snap, led).encode("utf-8")
            self._send(200, body, PROM_CONTENT_TYPE)
        elif path == "/metrics.json":
            doc = {
                "metrics": (registry.snapshot()
                            if registry is not None else None),
                "ledger": (ledger.snapshot()
                           if ledger is not None else None),
            }
            self._send(200, json.dumps(doc).encode("utf-8"),
                       "application/json")
        elif path == "/slo":
            slo = getattr(self.server, "slo", None)
            if slo is None:
                self._send(404, b"no slo monitor attached\n",
                           "text/plain; charset=utf-8")
                return
            self._send(200, json.dumps(slo.report()).encode("utf-8"),
                       "application/json")
        elif path == "/debug/slow":
            taillog = getattr(self.server, "taillog", None)
            if taillog is None:
                self._send(404, b"no tail log attached\n",
                           "text/plain; charset=utf-8")
                return
            self._send(200, json.dumps(taillog.snapshot()).encode("utf-8"),
                       "application/json")
        elif path == "/healthz":
            self._send(200, b"ok\n", "text/plain; charset=utf-8")
        else:
            self._send(404, b"not found\n", "text/plain; charset=utf-8")

    def log_message(self, fmt, *args):   # silence per-request stderr spam
        pass


class MetricsExporter:
    """Background exposition server over a registry + ledger pair."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 registry=None, ledger=None, slo=None, taillog=None):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._server.registry = registry       # type: ignore[attr-defined]
        self._server.ledger = ledger           # type: ignore[attr-defined]
        self._server.slo = slo                 # type: ignore[attr-defined]
        self._server.taillog = taillog         # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="metrics-exporter")
        self._thread.start()

    def attach(self, *, slo=None, taillog=None) -> None:
        """Wire an SLO monitor and/or tail log in after construction
        (drivers build them once the frontend exists)."""
        if slo is not None:
            self._server.slo = slo             # type: ignore[attr-defined]
        if taillog is not None:
            self._server.taillog = taillog     # type: ignore[attr-defined]

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
