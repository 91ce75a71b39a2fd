"""Approximation ledger: per-layer × per-epoch RSC budget accounting.

A copy of ``repro.obs.ledger``.

The rest of ``repro_torch.obs`` measures *time*; this module measures the
*approximation itself* — the thing RSC actually trades. For every sampled
or exact SpMM step the ledger records, per backward op (= per layer):

* **allocated** resources — the allocator's achieved cost vs its budget
  at every refresh (``note_allocation``), with a budget-conservation
  check: the greedy allocator GUARANTEES cost ≤ C·Σ full cost, so any
  violation (e.g. the uniform Fig. 6 baseline, whose cost is unbounded
  by design) is counted and, under ``strict=True`` / ``--strict-budget``,
  raised as :class:`BudgetError` — the same hard-fail contract as
  the reference's ``--strict-compiles`` (which the port, compiling
  nothing, does not have);
* **realized** resources — selected tiles, FLOPs and bytes moved per
  step (``note_step``), aggregated into one row per epoch
  (``end_epoch``) and published as ``rsc.ledger.*{layer=...}`` gauges;
* **backend decisions** — which lowering the autotuned dispatch picked
  per signature (``note_backend``);
* **probe results** — online exact-vs-sampled relative-error estimates
  with bootstrap CIs (:mod:`repro_torch.obs.probe`), attached to the epoch row.

The invariant is enforced at ALLOCATION granularity, not on raw steps:
plan caches bootstrap with the FULL exact plan until the first refresh
has gradient information, so early "rsc"-mode steps legitimately realize
full cost. Once the allocator has run, its achieved cost is what the
conservation claim is about.

Everything no-ops behind one ``enabled`` attribute check, like the
registry and tracer — the uninstrumented hot path pays nothing.
"""
from __future__ import annotations

import threading


class BudgetError(RuntimeError):
    """An allocation exceeded its budget under ``strict`` accounting."""


def _flops(tiles: int, bm: int, bk: int, d: int) -> int:
    """SpMM FLOPs of ``tiles`` (bm, bk) tiles against a d-wide operand."""
    return 2 * tiles * bm * bk * d


def _bytes_moved(tiles: int, bm: int, bk: int, d: int) -> int:
    """f32 traffic per tile: the tile itself + the gathered dense slab."""
    return tiles * (bm * bk + bk * d) * 4


class ApproxLedger:
    """Budget ledger behind one lock and an enable flag.

    The engine drives the lifecycle: ``set_dims`` once, ``set_epoch`` at
    epoch start, ``note_step`` per step, ``end_epoch`` (+ optional
    ``check``) at epoch end. Plan caches call ``note_allocation`` from
    inside ``refresh``; dispatch sites call ``note_backend``.
    """

    # Greedy cost arithmetic is exact prefix-sum float64; the epsilon only
    # forgives representation noise, never a real overshoot.
    _EPS = 1e-6

    def __init__(self, enabled: bool = False, strict: bool = False,
                 max_epochs: int = 1024):
        self.enabled = enabled
        self.strict = strict
        self.max_epochs = max_epochs
        self._lock = threading.Lock()
        self._epoch = 0
        self._dims: dict[str, int] = {}
        self._bm = self._bk = 1
        self._cur_ops: dict[str, dict] = {}
        self._cur_steps = {"rsc": 0, "exact": 0}
        self._cur_allocs: list[dict] = []
        self._cur_probes: dict[str, dict] = {}
        self.series: list[dict] = []
        self.allocations = 0
        self.violations = 0
        self.violation_msgs: list[str] = []
        self.backends: dict[str, str] = {}

    # -------------------------------------------------------------- setup
    def set_dims(self, dims: dict[str, int], bm: int, bk: int) -> None:
        """Per-op hidden dims + tile shape (FLOPs/bytes cost model)."""
        if not self.enabled:
            return
        with self._lock:
            self._dims = dict(dims)
            self._bm, self._bk = int(bm), int(bk)

    def set_epoch(self, epoch: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._epoch = int(epoch)

    # ------------------------------------------------------------- writes
    def note_allocation(self, *, scope: str, strategy: str, cost: float,
                        budget: float, k=None) -> None:
        """One allocator run: achieved cost vs budget (+ per-layer k)."""
        if not self.enabled:
            return
        ok = cost <= budget * (1.0 + self._EPS)
        with self._lock:
            self.allocations += 1
            self._cur_allocs.append({
                "scope": scope, "strategy": strategy,
                "cost": float(cost), "budget": float(budget),
                "k": (None if k is None else [int(x) for x in k]),
                "ok": bool(ok),
            })
            if not ok:
                self.violations += 1
                if len(self.violation_msgs) < 32:
                    self.violation_msgs.append(
                        f"epoch {self._epoch} scope {scope!r} "
                        f"({strategy}): cost {cost:.1f} > "
                        f"budget {budget:.1f}")

    def note_step(self, *, mode: str,
                  tiles_by_op: dict[str, int] | None = None) -> None:
        """One train step: realized tiles per op (rsc) or exact count."""
        if not self.enabled:
            return
        bm, bk = self._bm, self._bk
        with self._lock:
            self._cur_steps[mode] = self._cur_steps.get(mode, 0) + 1
            if mode != "rsc" or not tiles_by_op:
                return
            for op, tiles in tiles_by_op.items():
                tiles = int(tiles)
                d = self._dims.get(op, 1)
                row = self._cur_ops.get(op)
                if row is None:
                    row = self._cur_ops[op] = {
                        "steps": 0, "realized_tiles": 0,
                        "realized_flops": 0, "realized_bytes": 0}
                row["steps"] += 1
                row["realized_tiles"] += tiles
                row["realized_flops"] += _flops(tiles, bm, bk, d)
                row["realized_bytes"] += _bytes_moved(tiles, bm, bk, d)

    def note_backend(self, sig: str, backend: str) -> None:
        """Record which lowering dispatch resolved for a signature."""
        if not self.enabled:
            return
        with self._lock:
            if len(self.backends) < 512 or sig in self.backends:
                self.backends[sig] = backend

    def note_probe(self, op: str, *, rel_error: float, ci_lo: float,
                   ci_hi: float, n_rows: int) -> None:
        """Attach one error-probe result to the current epoch row."""
        if not self.enabled:
            return
        with self._lock:
            self._cur_probes[op] = {
                "rel_error": float(rel_error), "ci_lo": float(ci_lo),
                "ci_hi": float(ci_hi), "n_rows": int(n_rows)}

    # -------------------------------------------------------- epoch close
    def end_epoch(self, epoch: int, registry=None) -> dict | None:
        """Fold the current epoch into the series; publish gauges."""
        if not self.enabled:
            return None
        with self._lock:
            row = {
                "epoch": int(epoch),
                "steps": dict(self._cur_steps),
                "ops": {op: dict(r) for op, r in self._cur_ops.items()},
                "allocations": list(self._cur_allocs),
                "probes": dict(self._cur_probes),
            }
            self.series.append(row)
            if len(self.series) > self.max_epochs:
                del self.series[0]
            self._cur_ops = {}
            self._cur_steps = {"rsc": 0, "exact": 0}
            self._cur_allocs = []
            self._cur_probes = {}
        if registry is not None and registry.enabled:
            for op, r in row["ops"].items():
                registry.gauge("rsc.ledger.realized_tiles",
                               r["realized_tiles"], layer=op)
                registry.gauge("rsc.ledger.realized_flops",
                               r["realized_flops"], layer=op)
                registry.gauge("rsc.ledger.bytes_moved",
                               r["realized_bytes"], layer=op)
            for mode, n in row["steps"].items():
                if n:
                    registry.counter("rsc.ledger.steps", n, mode=mode)
            registry.gauge("rsc.ledger.allocations", self.allocations)
            registry.gauge("rsc.ledger.violations", self.violations)
        return row

    def check(self, where: str = "", hard_fail: bool | None = None) -> int:
        """Budget-conservation check; raise under strict accounting."""
        if not self.enabled:
            return 0
        hard = self.strict if hard_fail is None else hard_fail
        if hard and self.violations:
            msgs = "; ".join(self.violation_msgs[:4])
            raise BudgetError(
                f"{self.violations} allocation(s) exceeded the RSC budget"
                f"{' at ' + where if where else ''}: {msgs}")
        return self.violations

    # -------------------------------------------------------------- reads
    def snapshot(self) -> dict:
        """JSON-ready dump: the full per-epoch series + totals."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "epochs": [dict(r) for r in self.series],
                "allocations": self.allocations,
                "violations": self.violations,
                "violation_msgs": list(self.violation_msgs),
                "backends": dict(self.backends),
            }

    def summary(self) -> dict:
        """Compact totals for result JSONs (no per-epoch series)."""
        with self._lock:
            tiles = sum(r["realized_tiles"] for row in self.series
                        for r in row["ops"].values())
            flops = sum(r["realized_flops"] for row in self.series
                        for r in row["ops"].values())
            last_probes = {}
            for row in self.series:
                if row["probes"]:
                    last_probes = row["probes"]
            return {
                "epochs": len(self.series),
                "allocations": self.allocations,
                "violations": self.violations,
                "realized_tiles": tiles,
                "realized_flops": flops,
                "probes": last_probes,
            }
