"""The port's observability stack (``repro_torch.obs``) against the
reference's (``repro.obs``), and on the port's training and serving paths.

* Parity: the same inputs, from numpy seeds, through both packages give
  equal registry snapshots (quantiles included), snapshot deltas,
  Prometheus text, trace event structure (Chrome and JSONL, timestamps
  aside), ledger snapshots and summaries, SLO verdicts and burn rates,
  and ``probe_plan_error`` results to the last bit (the tiles given as a
  host array or as a tensor).
* The device-mesh-free cases of ``tests/test_obs.py``,
  ``tests/test_trace_slo.py`` and ``tests/test_ledger.py``, on the port.
* The engine with everything on: 30 full-batch steps from the
  reference's initial parameters give ``repro``'s ledger allocations,
  per-epoch rows and probe results, and the losses of the port's own run
  with observability off, bit for bit.
* The CLI flags: ``train gnn`` / ``train lm`` / ``serve_gnn`` with
  ``--metrics``, ``--metrics-port``, ``--trace-out``, ``--trace-jsonl``,
  ``--slo`` and (serving) ``--ckpt-dir``.

Everything runs on the CPU.
"""
import argparse
import json
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.plan import build_plan as jax_build_plan
from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
from repro.obs import export as jexport
from repro.obs import ledger as jledger
from repro.obs import probe as jprobe
from repro.obs import slo as jslo
from repro.obs.registry import MetricsRegistry as JaxRegistry
from repro.obs.registry import snapshot_delta as jax_snapshot_delta
from repro.obs.trace import Tracer as JaxTracer
from repro.train.loop import GNNTrainer as JaxGNNTrainer
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro_torch import convert, obs
from repro_torch.core.allocator import (LayerSpec, greedy_allocate,
                                        uniform_allocate)
from repro_torch.core.plan import build_plan, full_plan
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.launch import serve_gnn
from repro_torch.launch import train as train_cli
from repro_torch.obs import context as trace_context
from repro_torch.obs.clock import GuardedClock
from repro_torch.obs.context import TraceContext, new_trace
from repro_torch.obs.export import (PROM_CONTENT_TYPE, MetricsExporter,
                                    render_prometheus)
from repro_torch.obs.ledger import ApproxLedger, BudgetError
from repro_torch.obs.probe import bootstrap_ci, probe_plan_error
from repro_torch.obs.registry import MetricsRegistry, snapshot_delta
from repro_torch.obs.slo import (SLOError, SLOMonitor, monitor_from_args,
                                 parse_targets)
from repro_torch.obs.trace import Tracer
from repro_torch.pipeline import (MinibatchConfig, MinibatchTrainer,
                                  PoolConfig, Prefetcher, build_pool)
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.bcoo import csr_to_bcoo_host
from repro_torch.sparse.topology import sym_normalize
from repro_torch.train.loop import GNNTrainer, TrainConfig

REPO = Path(__file__).resolve().parents[1]
GRAPH = dict(n_nodes=400, n_clusters=4, avg_degree=10, feat_dim=16, seed=0)
# The engine run held against the reference: 30 full-batch steps, GCN 2 ×
# 24, block 32, batchnorm, dropout 0, RSC at budget 0.3, probes every epoch.
ENGINE = dict(model="gcn", n_layers=2, hidden=24, block=32, batchnorm=True,
              dropout=0.0, rsc=True, budget=0.3, epochs=30, seed=0)


@pytest.fixture(autouse=True)
def _fresh_obs():
    """The process-wide bundles must not leak between tests (off)."""
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return sbm_graph(**GRAPH)


# ================================================================= parity

def _feed_registry(reg, seed: int) -> None:
    """A seeded stream of counters, labelled gauges and observations."""
    rng = np.random.default_rng(seed)
    for i in range(400):
        v = float(rng.exponential(5.0))
        kind = int(rng.integers(0, 3))
        lbl = {"mode": ("rsc", "exact")[i % 2]} if i % 3 else {}
        if kind == 0:
            reg.counter("engine.steps", v, **lbl)
        elif kind == 1:
            reg.gauge("rsc.flops_fraction", v, layer=f"l{i % 4}")
        else:
            reg.observe("engine.step_ms", v, **lbl)
    with reg.timer("blk"):
        pass


@pytest.mark.parametrize("seed,cap", [(0, 4096), (1, 4096), (2, 32)])
def test_registry_snapshot_and_prometheus_match_reference(seed, cap):
    ours = MetricsRegistry(enabled=True, max_samples=cap)
    ref = JaxRegistry(enabled=True, max_samples=cap)
    _feed_registry(ours, seed)
    _feed_registry(ref, seed)
    a, b = ours.snapshot(), ref.snapshot()
    # the timer's own duration is a clock reading; everything else equal
    a["histograms"].pop("blk"), b["histograms"].pop("blk")
    assert a == b
    assert render_prometheus(a) == jexport.render_prometheus(b)
    before_a, before_b = dict(a), dict(b)
    _feed_registry(ours, seed + 10)
    _feed_registry(ref, seed + 10)
    da = snapshot_delta(before_a, ours.snapshot())
    db = jax_snapshot_delta(before_b, ref.snapshot())
    da["histograms"].pop("blk", None), db["histograms"].pop("blk", None)
    assert da == db


def _trace_script(tr, ctx_mod):
    """The same spans, instants and trace contexts on either tracer; the
    cross-thread span makes the Chrome export emit flow events."""
    ctx = ctx_mod.new_trace()
    with tr.span("outer", epoch=1):
        with tr.span("inner") as sp:
            sp.set(result=42)
        tr.instant("refresh", sub=3)
    with tr.span_in(ctx, "step", step=0):
        with tr.span("device_step", mode="rsc"):
            pass
    t = threading.Thread(target=lambda: tr.span_at(
        ctx, "upload", time.perf_counter() - 0.001, time.perf_counter(),
        sub="2"), name="subgraph-prefetch")
    t.start()
    t.join()


def _structure(events):
    """Event fields that do not depend on clocks, thread or id numbers."""
    keep = ("kind", "name", "depth", "parent", "args", "ph", "cat", "s",
            "bp")
    return [{k: e[k] for k in keep if k in e} for e in events]


def test_trace_event_structure_matches_reference(tmp_path):
    from repro.obs import context as jctx
    ours, ref = Tracer(enabled=True), JaxTracer(enabled=True)
    _trace_script(ours, trace_context)
    _trace_script(ref, jctx)
    assert _structure(ours.snapshot()) == _structure(ref.snapshot())
    ours.write_jsonl(tmp_path / "a.jsonl")
    ref.write_jsonl(tmp_path / "b.jsonl")
    assert (_structure(Tracer.read_jsonl(tmp_path / "a.jsonl"))
            == _structure(JaxTracer.read_jsonl(tmp_path / "b.jsonl")))
    ours.export_chrome(tmp_path / "a.json")
    ref.export_chrome(tmp_path / "b.json")
    a = json.loads((tmp_path / "a.json").read_text())
    b = json.loads((tmp_path / "b.json").read_text())
    assert _structure(a["traceEvents"]) == _structure(b["traceEvents"])
    assert a["otherData"] == b["otherData"]


def _ledger_script(led):
    led.set_dims({"gcn/spmm0": 24, "gcn/spmm1": 4}, bm=32, bk=32)
    rng = np.random.default_rng(3)
    for epoch in range(4):
        led.set_epoch(epoch)
        led.note_allocation(scope="full", strategy="greedy",
                            cost=float(rng.integers(10, 90)), budget=80.0,
                            k=rng.integers(0, 5, 2))
        for _ in range(3):
            led.note_step(mode="rsc", tiles_by_op={
                "gcn/spmm0": int(rng.integers(0, 40)),
                "gcn/spmm1": int(rng.integers(0, 40))})
        led.note_step(mode="exact")
        led.note_backend(f"kernel|d{epoch}", "kernel")
        led.note_probe("gcn/spmm0", rel_error=float(rng.random()),
                       ci_lo=0.1, ci_hi=0.9, n_rows=8)
        led.end_epoch(epoch, None)


def test_ledger_snapshot_and_summary_match_reference():
    ours, ref = ApproxLedger(enabled=True), jledger.ApproxLedger(enabled=True)
    _ledger_script(ours)
    _ledger_script(ref)
    assert ours.snapshot() == ref.snapshot()
    assert ours.summary() == ref.summary()
    assert ours.check() == ref.check() >= 1      # costs above 80 count
    assert render_prometheus({"counters": {}, "gauges": {},
                              "histograms": {}}, ours.snapshot()) == \
        jexport.render_prometheus({"counters": {}, "gauges": {},
                                   "histograms": {}}, ref.snapshot())


_SNAP_BAD = {"counters": {}, "gauges": {},
             "histograms": {"frontend.request_ms":
                            {"count": 10, "sum": 500.0, "p99": 50.0}}}
_SNAP_GOOD = {"counters": {}, "gauges": {},
              "histograms": {"frontend.request_ms":
                             {"count": 10, "sum": 5.0, "p99": 0.5}}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_verdicts_and_burn_rates_match_reference(seed):
    rng = np.random.default_rng(seed)
    targets = {"p99_ms": 5.0, "availability": 0.95, "staleness": 2.0}
    mons = [SLOMonitor(targets, windows=(10.0, 60.0), budget_frac=0.1,
                       registry=MetricsRegistry(enabled=True)),
            jslo.SLOMonitor(targets, windows=(10.0, 60.0), budget_frac=0.1,
                            registry=JaxRegistry(enabled=True))]
    outs = [[], []]
    for i in range(30):
        snap = dict(_SNAP_BAD if rng.random() < 0.5 else _SNAP_GOOD)
        snap["counters"] = {"frontend.requests": 100.0,
                            "frontend.failed": float(rng.integers(0, 9))}
        snap["gauges"] = {"frontend.staleness{replica=r0}":
                          float(rng.integers(0, 4))}
        for m, out in zip(mons, outs):
            out.append(m.tick(snapshot=snap, now=float(i * 3)))
            out.append({k: m.burn_rates(k, now=float(i * 3))
                        for k in targets})
            out.append(m.alerts(now=float(i * 3)))
    assert outs[0] == outs[1]
    assert mons[0]._registry.snapshot() == mons[1]._registry.snapshot()
    assert SLOMonitor.self_test() == jslo.SLOMonitor.self_test()


def _probe_operand(seed: int, n: int = 200, block: int = 16):
    """A symmetric-normalised random graph as a block-COO host operand."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < 0.05
    mask |= mask.T
    np.fill_diagonal(mask, False)
    rows, cols = np.nonzero(mask)
    csr = sym_normalize(CSR.from_coo(rows.astype(np.int64),
                                     cols.astype(np.int64),
                                     np.ones(rows.shape[0], np.float32),
                                     (n, n)))
    return csr_to_bcoo_host(csr, block, block)


@pytest.mark.parametrize("seed,frac,tiles_as", [
    (0, 0.5, "array"), (1, 0.2, "array"), (2, 0.8, "tensor"),
    (3, 0.0, "tensor")])
def test_probe_matches_reference_bit_for_bit(seed, frac, tiles_as):
    """The same tiles, meta, plan and seed give the reference's per-row
    errors, mean and bootstrap CI exactly; the tiles as a tensor (the
    full graph's, on the card) give the same numbers as the host array."""
    at, meta = _probe_operand(seed)
    keep = np.random.default_rng(seed + 9).random(at.n_col_blocks) < frac
    plan = build_plan(meta, keep, at.n_row_blocks, at.s_total, device="cpu")
    jplan = jax_build_plan(meta, keep, at.n_row_blocks, at.s_total)
    blocks = (at.blocks if tiles_as == "array"
              else torch.from_numpy(at.blocks))
    kw = dict(bm=at.bm, bk=at.bk, n_cols=at.n_col_blocks * at.bk,
              n_rows=6, d_probe=8, seed=seed + 100, op="op")
    ours = probe_plan_error(blocks, meta, plan, **kw)
    ref = jprobe.probe_plan_error(at.blocks, meta, jplan, **kw)
    assert np.array_equal(ours.rel_errors, ref.rel_errors)
    assert (ours.mean, ours.ci_lo, ours.ci_hi, ours.n_rows, ours.d) == \
        (ref.mean, ref.ci_lo, ref.ci_hi, ref.n_rows, ref.d)
    vals = np.random.default_rng(seed).random(25)
    assert bootstrap_ci(vals, seed=seed) == jprobe.bootstrap_ci(vals,
                                                                seed=seed)


# ============================================= carried over: registry etc.

def test_counter_and_gauge():
    reg = MetricsRegistry(enabled=True)
    reg.counter("c")
    reg.counter("c", 2.5)
    reg.gauge("g", 7.0)
    reg.gauge("g", 9.0)          # last write wins
    assert reg.get_counter("c") == pytest.approx(3.5)
    assert reg.get_gauge("g") == pytest.approx(9.0)
    assert reg.get_gauge("missing") is None
    assert reg.get_counter("missing") == 0.0


def test_labels_separate_instruments():
    reg = MetricsRegistry(enabled=True)
    reg.counter("steps", mode="rsc")
    reg.counter("steps", mode="exact")
    reg.counter("steps", mode="rsc")
    assert reg.get_counter("steps", mode="rsc") == 2.0
    assert reg.get_counter("steps", mode="exact") == 1.0
    assert "steps{mode=rsc}" in reg.snapshot()["counters"]
    reg.gauge("x", 1.0, b="2", a="1")
    assert "x{a=1,b=2}" in reg.snapshot()["gauges"]


def test_histogram_quantiles_match_numpy():
    reg = MetricsRegistry(enabled=True)
    vals = np.random.default_rng(0).exponential(10.0, size=1000)
    for v in vals:
        reg.observe("lat", float(v))
    h = reg.get_histogram("lat")
    assert h["count"] == 1000
    assert h["sum"] == pytest.approx(float(vals.sum()))
    assert (h["min"], h["max"]) == (float(vals.min()), float(vals.max()))
    s = np.sort(vals)
    for q, key in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
        assert h[key] == pytest.approx(float(s[round(q * 999)]))


def test_histogram_ring_buffer_keeps_newest():
    reg = MetricsRegistry(enabled=True, max_samples=10)
    for v in range(100):
        reg.observe("h", float(v))
    h = reg.get_histogram("h")
    assert h["count"] == 100 and h["min"] == 0.0 and h["max"] == 99.0
    assert h["p50"] >= 90.0      # quantiles over the newest window


def test_timer_observes_milliseconds():
    reg = MetricsRegistry(enabled=True)
    with reg.timer("blk", phase="x"):
        pass
    h = reg.get_histogram("blk", phase="x")
    assert h["count"] == 1 and 0.0 <= h["sum"] < 1000.0


def test_disabled_registry_is_noop():
    reg = MetricsRegistry(enabled=False)
    reg.counter("c")
    reg.gauge("g", 1.0)
    reg.observe("h", 1.0)
    with reg.timer("t"):
        pass
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_registry_reset():
    reg = MetricsRegistry(enabled=True)
    reg.counter("c")
    reg.reset()
    assert reg.get_counter("c") == 0.0


def test_snapshot_delta_reports_increments_only():
    reg = MetricsRegistry(enabled=True)
    reg.counter("steps", 2, mode="rsc")
    reg.counter("unchanged")
    reg.gauge("lr", 0.01)
    reg.gauge("stable", 7.0)
    reg.observe("ms", 1.0)
    before = reg.snapshot()
    reg.counter("steps", 3, mode="rsc")
    reg.counter("born")
    reg.gauge("lr", 0.005)
    reg.gauge("stable", 7.0)
    reg.observe("ms", 2.0)
    reg.observe("ms", 4.0)
    delta = snapshot_delta(before, reg.snapshot())
    assert delta["counters"] == {"steps{mode=rsc}": 3.0, "born": 1.0}
    assert delta["gauges"] == {"lr": 0.005}
    assert delta["histograms"] == {"ms": {"count": 2, "sum": 6.0}}
    snap = reg.snapshot()
    assert snapshot_delta(snap, reg.snapshot()) == {
        "counters": {}, "gauges": {}, "histograms": {}}


def test_guarded_clock_clamps_negative_deltas():
    ticks = iter([10.0, 5.0, 5.0, 7.5])
    clk = GuardedClock(now=lambda: next(ticks))
    t0 = clk.now()
    assert clk.elapsed(t0) == 0.0 and clk.anomalies == 1
    t1 = clk.now()
    assert clk.elapsed(t1) == pytest.approx(2.5) and clk.anomalies == 1


def test_configure_flips_global_flags():
    assert not obs.get_obs().enabled
    obs.configure(metrics=True)
    assert obs.get_registry().enabled and not obs.get_tracer().enabled
    obs.configure(trace=True)
    assert obs.get_obs().enabled
    obs.configure(metrics=False, trace=False)
    assert not obs.get_obs().enabled


# ================================================== carried over: tracing

def test_span_nesting_depth_and_parent():
    tr = Tracer(enabled=True)
    with tr.span("outer", epoch=1):
        with tr.span("inner") as sp:
            sp.set(result=42)
    evs = tr.snapshot()
    by_name = {e["name"]: e for e in evs}
    assert by_name["inner"]["depth"] == 1
    assert by_name["inner"]["parent"] == "outer"
    assert by_name["inner"]["args"] == {"result": 42}
    assert by_name["outer"]["depth"] == 0 and by_name["outer"]["parent"] is None
    assert evs[0]["name"] == "inner"
    assert by_name["outer"]["dur_us"] >= by_name["inner"]["dur_us"]


def test_jsonl_round_trip(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("a", k="v"):
        tr.instant("mark", x=1)
    tr.write_jsonl(tmp_path / "spans.jsonl")
    assert Tracer.read_jsonl(tmp_path / "spans.jsonl") == tr.snapshot()


def test_chrome_export_is_valid_trace(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("step", step=0):
        tr.instant("refresh")
    tr.export_chrome(tmp_path / "trace.json")
    doc = json.loads((tmp_path / "trace.json").read_text())
    evs = doc["traceEvents"]
    assert {"M", "X", "i"} <= {e["ph"] for e in evs}
    x = next(e for e in evs if e["ph"] == "X")
    assert x["name"] == "step" and x["dur"] >= 0 and "ts" in x
    assert doc["otherData"]["dropped_events"] == 0


def test_disabled_tracer_records_nothing():
    tr = Tracer(enabled=False)
    with tr.span("a") as sp:
        sp.set(x=1)
    tr.instant("b")
    assert tr.snapshot() == []


def test_event_cap_counts_dropped():
    tr = Tracer(enabled=True, max_events=2)
    for i in range(5):
        tr.instant(f"e{i}")
    assert len(tr.snapshot()) == 2 and tr.dropped == 3


def test_flush_writes_once_and_is_idempotent(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("work"):
        pass
    chrome, jsonl = tmp_path / "t.json", tmp_path / "t.jsonl"
    tr.install_flush(chrome=chrome, jsonl=jsonl)
    assert tr.flush() is True
    assert tr.flush() is False
    doc = json.loads(chrome.read_text())
    assert any(e["ph"] == "X" and e["name"] == "work"
               for e in doc["traceEvents"])
    assert Tracer.read_jsonl(jsonl) == tr.snapshot()


def test_flushing_scope_writes_on_exception(tmp_path):
    tr = Tracer(enabled=True)
    p = tmp_path / "crash.jsonl"
    with pytest.raises(RuntimeError, match="boom"):
        with tr.flushing(jsonl=p):
            tr.instant("before_crash")
            raise RuntimeError("boom")
    assert [e["name"] for e in Tracer.read_jsonl(p)] == ["before_crash"]


def test_uninstall_flush_disarms(tmp_path):
    tr = Tracer(enabled=True)
    p = tmp_path / "never.jsonl"
    tr.install_flush(jsonl=p)
    tr.uninstall_flush()
    assert tr.flush() is False and not p.exists()


def test_atexit_flush_survives_interpreter_exit(tmp_path):
    out = tmp_path / "atexit.jsonl"
    code = ("import sys\n"
            "from repro_torch.obs.trace import Tracer\n"
            "tr = Tracer(enabled=True)\n"
            f"tr.install_flush(jsonl={str(out)!r})\n"
            "tr.instant('unflushed')\n"
            "sys.exit(0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(REPO / "src"),
                                          "PATH": "/usr/bin:/bin"},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [e["name"] for e in Tracer.read_jsonl(out)] == ["unflushed"]


def test_trace_context_ids_and_children():
    a, b = new_trace(), new_trace()
    assert a.trace_id != b.trace_id
    assert a.span_id == a.trace_id and a.parent_id is None
    c = a.child()
    assert c.trace_id == a.trace_id
    assert c.parent_id == a.span_id and c.span_id != a.span_id


def test_current_context_is_thread_local():
    ctx = new_trace()
    seen = []
    with trace_context.use(ctx):
        assert trace_context.current() is ctx
        t = threading.Thread(
            target=lambda: seen.append(trace_context.current()))
        t.start()
        t.join()
    assert seen == [None] and trace_context.current() is None
    with trace_context.use(None):
        assert trace_context.current() is None


def test_pending_handoff_is_take_once():
    ctx = new_trace()
    trace_context.set_pending(ctx)
    assert trace_context.take_pending() is ctx
    assert trace_context.take_pending() is None


def test_span_auto_joins_current_context():
    ob = obs.reset(trace=True)
    ctx = new_trace()
    with trace_context.use(ctx):
        with ob.tracer.span("inner"):
            pass
    with ob.tracer.span("outside"):
        pass
    evs = {e["name"]: e for e in ob.tracer.snapshot()}
    assert evs["inner"]["trace"] == ctx.trace_id
    assert evs["inner"]["parent_span"] == ctx.span_id
    assert "trace" not in evs["outside"]


def test_span_in_nests_and_span_at_backfills():
    ob = obs.reset(trace=True)
    ctx = new_trace()
    with ob.tracer.span_in(ctx, "outer"):
        with ob.tracer.span("nested"):
            pass
    t0 = time.perf_counter() - 0.010
    ob.tracer.span_at(ctx, "retro", t0, t0 + 0.005, k="v")
    evs = {e["name"]: e for e in ob.tracer.snapshot()}
    assert evs["outer"]["trace"] == evs["nested"]["trace"] == ctx.trace_id
    assert evs["nested"]["parent_span"] == evs["outer"]["span"]
    retro = evs["retro"]
    assert retro["trace"] == ctx.trace_id
    assert 4500 < retro["dur_us"] < 5500 and retro["args"] == {"k": "v"}


def test_chrome_flow_events_only_for_multithread_traces(tmp_path):
    ob = obs.reset(trace=True)
    multi, single = new_trace(), new_trace()
    with ob.tracer.span_in(single, "solo"):
        pass
    with ob.tracer.span_in(multi, "here"):
        pass
    t = threading.Thread(target=lambda: ob.tracer.span_at(
        multi, "there", time.perf_counter() - 0.001, time.perf_counter()))
    t.start()
    t.join()
    ob.tracer.export_chrome(tmp_path / "trace.json")
    doc = json.loads((tmp_path / "trace.json").read_text())
    flows = [e for e in doc["traceEvents"] if e.get("cat") == "flow"]
    assert {e["id"] for e in flows} == {multi.trace_id}
    assert sorted(e["ph"] for e in flows) == ["f", "s"]
    assert [e for e in flows if e["ph"] == "f"][0]["bp"] == "e"


@pytest.mark.parametrize("threaded", [True, False])
def test_prefetcher_baton_links_upload_to_consumer(graph, threaded):
    """Each batch's upload span (on the worker thread when threaded) and
    the consumer's step span share one trace id through the baton."""
    pool = build_pool(graph, PoolConfig(n_subgraphs=3, roots=30,
                                        walk_length=2, n_buckets=1,
                                        block=32))
    ob = obs.reset(trace=True)
    for sid, _ops in Prefetcher(pool, [0, 1, 2], device="cpu",
                                enabled=threaded):
        ctx = trace_context.take_pending()
        assert isinstance(ctx, TraceContext)
        with ob.tracer.span_in(ctx, "step", sid=int(sid)):
            pass
    by_trace: dict = {}
    for e in ob.tracer.snapshot():
        if e.get("trace"):
            by_trace.setdefault(e["trace"], set()).add(e["name"])
    assert sum({"upload", "step"} <= n for n in by_trace.values()) == 3


def test_engine_step_adopts_prefetch_trace(graph):
    """Minibatch training with tracing on: step spans share a trace id
    with the upload span (on the prefetch thread) that fed them, and the
    prefetch metrics count every upload."""
    ob = obs.reset(metrics=True, trace=True)
    cfg = MinibatchConfig(model="gcn", n_layers=2, hidden=16, epochs=2,
                          rsc=True, n_subgraphs=4, n_buckets=1, roots=30,
                          walk_length=3, autotune=False, block=32,
                          device="cpu")
    tr = MinibatchTrainer(cfg, graph)
    tr.train(eval_every=2)
    by_trace: dict = {}
    for e in ob.tracer.snapshot():
        if e["kind"] == "span" and e.get("trace"):
            by_trace.setdefault(e["trace"], []).append(e)
    linked = 0
    for spans in by_trace.values():
        if {"upload", "step"} <= {e["name"] for e in spans}:
            assert len({e["tid"] for e in spans}) >= 2
            linked += 1
    assert linked == 8                          # 2 epochs × 4 subgraphs
    reg = ob.registry
    src = tr.engine.source.transfer_stats()
    assert reg.get_counter("prefetch.uploads") == src["uploads"]
    assert reg.get_histogram("prefetch.upload_ms")["count"] == src["uploads"]
    pp = tr.plan_pool.stats
    assert (reg.get_counter("plan_pool.hits", pool="pool")
            + reg.get_counter("plan_pool.refreshes", pool="pool")
            + reg.get_counter("plan_pool.cold", pool="pool")) == \
        pp.lookups == tr.history["mode"].count("rsc")
    assert reg.get_histogram("plan_pool.refresh_ms",
                             pool="pool")["count"] == pp.refreshes


# ======================================================= carried over: SLO

def test_slo_burn_rates_and_alerts():
    mon = SLOMonitor({"p99_ms": 5.0}, windows=(10.0, 60.0), budget_frac=0.05)
    for i in range(12):
        mon.tick(snapshot=_SNAP_BAD, now=float(i * 5))
    burn = mon.burn_rates("p99_ms", now=55.0)
    assert burn["10s"] == pytest.approx(20.0)
    assert burn["60s"] == pytest.approx(20.0)
    assert mon.alerts(now=55.0) == ["p99_ms"]
    for i in range(12, 16):
        mon.tick(snapshot=_SNAP_GOOD, now=float(i * 5))
    assert mon.burn_rates("p99_ms", now=77.0)["10s"] == 0.0
    assert mon.alerts(now=77.0) == []


def test_slo_availability_and_no_data():
    mon = SLOMonitor({"availability": 0.99, "staleness": 3.0})
    ev = mon.tick(snapshot={"counters": {}, "gauges": {}, "histograms": {}},
                  now=0.0)
    assert ev["availability"]["no_data"] and ev["staleness"]["no_data"]
    snap = {"counters": {"frontend.requests": 100.0,
                         "frontend.deadline_dropped": 3.0,
                         "frontend.failed": 1.0},
            "gauges": {"frontend.staleness{replica=r0}": 1.0,
                       "frontend.staleness{replica=r1}": 5.0},
            "histograms": {}}
    ev = mon.tick(snapshot=snap, now=1.0)
    assert ev["availability"]["value"] == pytest.approx(0.96)
    assert not ev["availability"]["ok"]
    assert ev["staleness"]["value"] == 5.0 and not ev["staleness"]["ok"]


def test_slo_self_test_and_strict_check():
    st = SLOMonitor.self_test()
    assert st["pass"] and st["alerted"] == ["p99_ms"]
    mon = SLOMonitor({"p99_ms": 5.0}, windows=(5.0, 10.0))
    for _ in range(6):
        mon.tick(snapshot=_SNAP_BAD)
    assert mon.check() == ["p99_ms"]
    with pytest.raises(SLOError, match="p99_ms"):
        mon.check(where="test", hard_fail=True)


def test_slo_publishes_gauges_and_report():
    reg = obs.reset(metrics=True).registry
    mon = SLOMonitor({"p99_ms": 5.0}, registry=reg, windows=(5.0, 10.0))
    for i in range(6):
        mon.tick(snapshot=_SNAP_BAD, now=float(i * 2))
    gauges = reg.snapshot()["gauges"]
    assert gauges["rsc.slo.value{slo=p99_ms}"] == 50.0
    assert gauges["rsc.slo.target{slo=p99_ms}"] == 5.0
    assert gauges["rsc.slo.ok{slo=p99_ms}"] == 0.0
    assert gauges["rsc.slo.alert{slo=p99_ms}"] == 1.0
    assert gauges["rsc.slo.burn_rate{slo=p99_ms,window=5s}"] > 1.0
    rep = mon.report(snapshot=_SNAP_BAD)
    assert rep["objectives"]["p99_ms"]["alert"] and rep["self_test"]["pass"]


def test_slo_parse_targets_and_cli_validation():
    assert parse_targets(["p99_ms=50", "availability=0.99"]) == {
        "p99_ms": 50.0, "availability": 0.99}
    with pytest.raises(ValueError, match="KEY=TARGET"):
        parse_targets(["nope=1"])
    with pytest.raises(ValueError):
        parse_targets(["p99_ms"])
    from repro_torch.obs import slo as slo_mod
    ap = argparse.ArgumentParser()
    slo_mod.add_cli_flags(ap)
    mon = monitor_from_args(ap.parse_args(["--slo", "p99_ms=50",
                                           "--strict-slo"]))
    assert [o.key for o in mon.objectives] == ["p99_ms"]
    with pytest.raises(SystemExit, match="strict-slo"):
        monitor_from_args(ap.parse_args(["--strict-slo"]))
    assert monitor_from_args(ap.parse_args([])) is None


def test_slo_endpoint():
    reg = obs.reset(metrics=True).registry
    with MetricsExporter(port=0, registry=reg) as ex:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{ex.url}/slo")
        assert e.value.code == 404            # no monitor attached
        mon = SLOMonitor({"staleness": 100.0}, registry=reg)
        ex.attach(slo=mon)
        with urllib.request.urlopen(f"{ex.url}/slo") as r:
            doc = json.loads(r.read())
        assert "staleness" in doc["objectives"]
        assert doc["self_test"]["pass"] is True


# ============================================ carried over: ledger, probes

def test_ledger_disabled_is_noop():
    led = ApproxLedger(enabled=False)
    led.set_dims({"op": 8}, bm=4, bk=4)
    led.note_allocation(scope="x", strategy="greedy", cost=2.0, budget=1.0)
    led.note_step(mode="rsc", tiles_by_op={"op": 7})
    assert led.end_epoch(0) is None
    assert led.check("noop", hard_fail=True) == 0
    assert led.allocations == 0 and led.violations == 0


def test_ledger_accumulates_and_rolls_epochs():
    led = ApproxLedger(enabled=True)
    led.set_dims({"a": 16, "b": 8}, bm=4, bk=4)
    led.set_epoch(0)
    led.note_step(mode="rsc", tiles_by_op={"a": 3, "b": 5})
    led.note_step(mode="rsc", tiles_by_op={"a": 2})
    led.note_step(mode="exact")
    row = led.end_epoch(0)
    assert row["steps"] == {"rsc": 2, "exact": 1}
    assert row["ops"]["a"]["realized_tiles"] == 5
    assert row["ops"]["a"]["realized_flops"] == 2 * 5 * 4 * 4 * 16
    assert row["ops"]["b"]["realized_bytes"] == 5 * (16 + 4 * 8) * 4
    led.set_epoch(1)
    led.note_step(mode="rsc", tiles_by_op={"a": 1})
    assert led.end_epoch(1)["ops"]["a"]["realized_tiles"] == 1
    s = led.summary()
    assert s["epochs"] == 2 and s["realized_tiles"] == 11


def test_greedy_conserves_uniform_violates_and_strict_raises():
    spec = LayerSpec(scores=np.array([10.0, 1.0, 1.0, 1.0]),
                     tiles=np.array([100, 1, 1, 1]), d=4, norm=1.0)
    g = greedy_allocate([spec], 0.5, step_frac=0.25)
    assert g.cost <= g.budget + 1e-9
    u = uniform_allocate([spec], 0.5)
    assert u.cost > u.budget
    led = ApproxLedger(enabled=True)
    led.note_allocation(scope="l", strategy="greedy", cost=g.cost,
                        budget=g.budget, k=g.k)
    assert led.violations == 0
    led.note_allocation(scope="l", strategy="uniform", cost=u.cost,
                        budget=u.budget, k=u.k)
    assert led.violations == 1 and led.check("soft") == 1
    with pytest.raises(BudgetError, match="exceeded the RSC budget"):
        led.check("hard", hard_fail=True)
    snap = led.snapshot()
    assert snap["violations"] == 1 and snap["violation_msgs"]


def test_fullbatch_budget_conservation(graph):
    ob = obs.reset(metrics=True, ledger=True)
    cfg = TrainConfig(model="gcn", n_layers=2, hidden=32, dropout=0.0,
                      epochs=12, rsc=True, budget=0.5, block=32,
                      refresh_every=3, strict_budget=True, device="cpu")
    res = GNNTrainer(cfg, graph).train(eval_every=6)
    led = res["ledger"]
    assert led["allocations"] >= 1 and led["violations"] == 0
    assert led["realized_tiles"] > 0 and led["probes"]
    for row in ob.ledger.series:
        for a in row["allocations"]:
            assert a["ok"] and a["cost"] <= a["budget"] * (1 + 1e-6)
    for p in led["probes"].values():
        assert p["ci_lo"] <= p["rel_error"] <= p["ci_hi"]
    assert ob.registry.get_gauge("rsc.ledger.realized_tiles",
                                 layer="gcn/spmm0") > 0
    assert ob.registry.get_counter("rsc.ledger.steps", mode="rsc") > 0
    # the last allocation's achieved cost is the run's FLOPs fraction
    last = [a for row in ob.ledger.series for a in row["allocations"]][-1]
    assert last["cost"] / last["budget"] * 0.5 == pytest.approx(
        res["flops_fraction"], abs=1e-12)


def test_fullbatch_exact_probe_is_zero_error(graph):
    obs.reset(ledger=True)
    cfg = TrainConfig(model="gcn", n_layers=2, hidden=32, epochs=4,
                      rsc=True, budget=1.0, switching=False, block=32,
                      refresh_every=2, device="cpu")
    probes = GNNTrainer(cfg, graph).train(eval_every=4)["ledger"]["probes"]
    assert probes
    for p in probes.values():
        assert p["rel_error"] < 1e-8 and p["ci_hi"] < 1e-8


def test_minibatch_budget_conservation(graph):
    ob = obs.reset(metrics=True, ledger=True)
    cfg = MinibatchConfig(model="gcn", n_layers=2, hidden=32, epochs=4,
                          rsc=True, budget=0.5, n_subgraphs=4, n_buckets=2,
                          roots=40, walk_length=3, autotune=False, block=32,
                          strict_budget=True, device="cpu")
    res = MinibatchTrainer(cfg, graph).train(eval_every=2)
    led = res["ledger"]
    assert led["allocations"] >= 1 and led["violations"] == 0
    assert led["realized_tiles"] > 0 and led["probes"]
    scopes = set()
    for row in ob.ledger.series:
        for a in row["allocations"]:
            assert a["ok"], a
            scopes.add(a["scope"])
    assert any(s.startswith("sub") for s in scopes)
    # the kernel wrapper's dispatch signatures were recorded
    assert ob.ledger.backends and set(ob.ledger.backends.values()) == \
        {"kernel_plain"}


def test_strict_budget_raises_under_uniform(graph):
    """``uniform`` keeps at least one column block per op, about 1/13 of
    the tiles here, so a 1 % budget is exceeded at its first refresh."""
    obs.reset(ledger=True)
    cfg = TrainConfig(model="gcn", n_layers=2, hidden=16, epochs=6,
                      rsc=True, budget=0.01, block=32, refresh_every=2,
                      strategy="uniform", strict_budget=True, device="cpu")
    with pytest.raises(BudgetError):
        GNNTrainer(cfg, graph).train(eval_every=6)


def test_probe_matches_dense_oracle():
    at, meta = _probe_operand(seed=5)
    n_cb = at.n_col_blocks
    keep = np.random.default_rng(1).random(n_cb) < 0.5
    keep[0] = True
    plan = build_plan(meta, keep, at.n_row_blocks, at.s_total, device="cpu")
    seed, n_rows, d_probe = 7, 6, 8
    res = probe_plan_error(at.blocks, meta, plan, bm=at.bm, bk=at.bk,
                           n_cols=n_cb * at.bk, n_rows=n_rows,
                           d_probe=d_probe, seed=seed)
    assert res is not None and res.n_rows == n_rows
    oracle_rng = np.random.default_rng(seed)
    rows = np.sort(oracle_rng.choice(np.unique(meta.row_ids), size=n_rows,
                                     replace=False))
    h = oracle_rng.standard_normal((n_cb, at.bk, d_probe)).reshape(
        n_cb * at.bk, d_probe)

    def dense(row_ids, col_ids, tile_idx):
        a = np.zeros((at.n_row_blocks * at.bm, n_cb * at.bk))
        for r, c, s in zip(row_ids, col_ids, tile_idx):
            a[r * at.bm:(r + 1) * at.bm, c * at.bk:(c + 1) * at.bk] += \
                at.blocks[s]
        return a

    exact = dense(meta.row_ids, meta.col_ids,
                  np.arange(meta.row_ids.shape[0])) @ h
    sel = plan.sel.numpy()
    live = sel != at.s_total
    approx = dense(plan.row_ids.numpy()[live], plan.col_ids.numpy()[live],
                   sel[live]) @ h
    for i, r in enumerate(rows):
        e = exact[r * at.bm:(r + 1) * at.bm]
        d = e - approx[r * at.bm:(r + 1) * at.bm]
        want = np.linalg.norm(d) / max(np.linalg.norm(e), 1e-12)
        assert res.rel_errors[i] == pytest.approx(want, rel=1e-9)
    assert res.ci_lo <= res.mean <= res.ci_hi


def test_probe_full_plan_is_exact():
    at, meta = _probe_operand(seed=2)
    plan = full_plan(meta, at.n_row_blocks, at.s_total, device="cpu")
    res = probe_plan_error(torch.from_numpy(at.blocks), meta, plan,
                           bm=at.bm, bk=at.bk,
                           n_cols=at.n_col_blocks * at.bk, n_rows=5,
                           d_probe=4, seed=3)
    assert res.mean == pytest.approx(0.0, abs=1e-10)
    assert res.ci_hi == pytest.approx(0.0, abs=1e-10)


def test_bootstrap_ci_covers_true_mean():
    rng = np.random.default_rng(0)
    hits, trials = 0, 60
    for t in range(trials):
        lo, hi = bootstrap_ci(rng.exponential(0.3, size=40), n_boot=300,
                              seed=t)
        hits += lo <= 0.3 <= hi
    assert hits / trials > 0.75
    lo, hi = bootstrap_ci([])
    assert np.isnan(lo) and np.isnan(hi)
    assert bootstrap_ci([2.0]) == (2.0, 2.0)


# ====================================================== carried over: export

_PROM_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{(?P<labels>(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*)\})?'
    r' (?P<value>\S+)$')


def _scrape_parse(text):
    """Strict text-format 0.0.4 parser: {family: (kind, samples)}, with
    the structural invariants a real scraper relies on asserted."""
    families: dict = {}
    current = None
    assert text.endswith("\n")
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("#"):
            m = re.match(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
                         r"(counter|gauge|summary|histogram|untyped)$", line)
            assert m, f"malformed TYPE line: {line!r}"
            assert m.group(1) not in families
            families[m.group(1)] = (m.group(2), [])
            current = m.group(1)
            continue
        m = _SAMPLE.match(line)
        assert m, f"malformed sample line: {line!r}"
        name = m.group("name")
        assert _PROM_NAME.match(name)
        float(m.group("value"))
        fam = None
        for suffix in ("", "_sum", "_count"):
            if suffix and not name.endswith(suffix):
                continue
            cand = name[: -len(suffix)] if suffix else name
            if cand in families:
                fam = cand
                break
        if fam is None:
            families.setdefault(name, ("untyped-implicit", []))
            fam = name
        else:
            assert current == fam or families[fam][0].startswith("untyped")
        labels = dict(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)='
                                 r'"((?:[^"\\]|\\.)*)"',
                                 m.group("labels") or ""))
        key = (name, tuple(sorted(labels.items())))
        assert key not in families[fam][1], f"duplicate sample {key}"
        families[fam][1].append(key)
    return families


def test_prometheus_render_conformance():
    reg = obs.reset(metrics=True).registry
    reg.counter("frontend.requests", 3.0)
    reg.counter("frontend.requests", 2.0)
    reg.gauge("rsc.slo.ok", 1.0, slo="p99_ms")
    reg.gauge("rsc.slo.ok", 0.0, slo="staleness")
    reg.gauge("weird.gauge", 1.0, who='he said "hi"\nback\\slash')
    for v in (1.0, 2.0, 3.0):
        reg.observe("frontend.request_ms", v, replica="r0")
    fams = _scrape_parse(render_prometheus(
        reg.snapshot(), {"enabled": True, "epochs": [1], "violations": 0}))
    assert fams["frontend_requests"][0] == "counter"
    assert fams["rsc_slo_ok"][0] == "gauge"
    assert fams["frontend_request_ms"][0] == "summary"
    names = [n for n, _ in fams["frontend_request_ms"][1]]
    assert names.count("frontend_request_ms") == 3
    assert {"frontend_request_ms_sum", "frontend_request_ms_count"} <= \
        set(names)
    assert fams["rsc_ledger_epochs_total"][0] == "counter"
    esc = [lbls for n, lbls in fams["weird_gauge"][1]][0]
    assert dict(esc)["who"] == 'he said \\"hi\\"\\nback\\\\slash'


def test_prometheus_sanitization_collision_demotes_to_untyped():
    body = render_prometheus({"counters": {"a.b": 1.0},
                              "gauges": {"a_b": 2.0}, "histograms": {}})
    assert "# TYPE a_b" not in body and body.count("a_b ") == 1
    _scrape_parse(body)


def test_render_prometheus_lines():
    reg = MetricsRegistry(enabled=True)
    reg.counter("engine.steps", 3, mode="rsc")
    reg.gauge("rsc.ledger.realized_tiles", 42.0, layer="gcn/spmm0")
    reg.gauge("weird.name-x", 1.0, lbl='va"l\\ue\nz')
    for v in (1.0, 2.0, 3.0):
        reg.observe("engine.step_ms", v)
    lines = render_prometheus(reg.snapshot()).splitlines()
    assert "# TYPE engine_steps counter" in lines
    assert 'engine_steps{mode="rsc"} 3.0' in lines
    assert 'rsc_ledger_realized_tiles{layer="gcn/spmm0"} 42.0' in lines
    assert 'weird_name_x{lbl="va\\"l\\\\ue\\nz"} 1.0' in lines
    assert "# TYPE engine_step_ms summary" in lines
    assert 'engine_step_ms{quantile="0.5"} 2.0' in lines
    assert "engine_step_ms_sum 6.0" in lines
    assert "engine_step_ms_count 3.0" in lines


def test_exporter_endpoints_and_content_type():
    reg = MetricsRegistry(enabled=True)
    reg.gauge("g", 1.5, layer="a/b")
    led = ApproxLedger(enabled=True)
    led.note_allocation(scope="s", strategy="greedy", cost=1.0, budget=2.0)
    led.end_epoch(0)
    with MetricsExporter(port=0, registry=reg, ledger=led) as ex:
        with urllib.request.urlopen(f"{ex.url}/metrics") as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == PROM_CONTENT_TYPE
            body = r.read().decode()
        assert 'g{layer="a/b"} 1.5' in body
        assert "rsc_ledger_epochs_total 1" in body
        assert "rsc_ledger_alloc_violations_total 0" in body
        with urllib.request.urlopen(f"{ex.url}/metrics.json") as r:
            doc = json.loads(r.read())
        assert doc["metrics"]["gauges"]["g{layer=a/b}"] == 1.5
        assert doc["ledger"]["allocations"] == 1
        with urllib.request.urlopen(f"{ex.url}/healthz") as r:
            assert r.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{ex.url}/debug/slow")  # no tail log


def test_live_endpoint_during_training(graph):
    ob = obs.reset(metrics=True, ledger=True)
    cfg = TrainConfig(model="gcn", n_layers=2, hidden=32, epochs=30,
                      rsc=True, budget=0.5, block=32, refresh_every=3,
                      device="cpu")
    tr = GNNTrainer(cfg, graph)
    with MetricsExporter(port=0, registry=ob.registry,
                         ledger=ob.ledger) as ex:
        th = threading.Thread(target=tr.train, kwargs={"eval_every": 30},
                              daemon=True)
        th.start()
        th.join(timeout=120)
        with urllib.request.urlopen(f"{ex.url}/metrics") as r:
            body = r.read().decode()
    assert 'rsc_ledger_realized_tiles{layer="gcn/spmm0"}' in body
    assert 'rsc_probe_ci_hi{layer="gcn/spmm0"}' in body
    assert 'rsc_probe_ci_lo{layer="gcn/spmm0"}' in body
    assert "rsc_ledger_alloc_violations_total 0" in body
    _scrape_parse(body)


# ========================================= the engine against the reference

@pytest.fixture(scope="module")
def reference_ledger_run():
    """``repro``'s 30 steps with metrics and the ledger on: its initial
    params, losses, ledger series and summary."""
    jobs.reset(metrics=True, ledger=True)
    tr = JaxGNNTrainer(JaxTrainConfig(**ENGINE, backend="jnp"),
                       jax_sbm_graph(**GRAPH))
    init = jax.device_get(tr.engine.params)
    res = tr.train(eval_every=10)
    series = jobs.get_ledger().snapshot()["epochs"]
    jobs.reset()
    return init, res, series


def _port_run(graph, init, *, on: bool, tmp_path=None):
    ob = obs.reset(metrics=on, trace=on, ledger=on)
    tr = GNNTrainer(TrainConfig(**ENGINE, device="cpu"), graph,
                    model=convert.gnn_params_from_numpy("gcn", init,
                                                        device="cpu"))
    res = tr.train(eval_every=10)
    return tr, res, ob


def test_engine_ledger_and_probes_match_reference(graph,
                                                  reference_ledger_run):
    init, jres, jseries = reference_ledger_run
    _, res, ob = _port_run(graph, init, on=True)
    series = ob.ledger.snapshot()["epochs"]
    assert len(series) == len(jseries) == 30
    for ours, ref in zip(series, jseries):
        assert ours["allocations"] == ref["allocations"], ours["epoch"]
        assert ours["steps"] == ref["steps"] and ours["ops"] == ref["ops"]
        assert ours["probes"] == ref["probes"], ours["epoch"]
    assert sum(bool(r["probes"]) for r in series) == 30
    assert res["ledger"] == jres["ledger"]
    np.testing.assert_allclose(res["history"]["loss"],
                               jres["history"]["loss"], rtol=1e-5)


def test_engine_observability_changes_no_numerics(graph,
                                                  reference_ledger_run):
    """Metrics, tracing, the ledger and the probes on give the losses and
    final parameters of the run with them off, bit for bit; the step
    histograms count every step and the spans nest as the reference's."""
    init = reference_ledger_run[0]
    off, res_off, _ = _port_run(graph, init, on=False)
    on, res_on, ob = _port_run(graph, init, on=True)
    assert res_on["history"]["loss"] == res_off["history"]["loss"]
    assert res_off["ledger"] is None
    for (n, a), (_, b) in zip(off.params.named_parameters(),
                              on.params.named_parameters()):
        assert torch.equal(a, b), n
    reg = ob.registry
    modes = res_on["history"]["mode"]
    for mode in ("rsc", "exact"):
        assert reg.get_histogram("engine.step_ms", mode=mode)["count"] == \
            modes.count(mode) == reg.get_counter("engine.steps", mode=mode)
    assert reg.get_histogram("engine.eval_ms")["count"] == 4
    assert reg.get_histogram("engine.sample_ms")["count"] == 30
    names = [e["name"] for e in ob.tracer.snapshot()]
    assert names.count("step") == names.count("device_step") == 30
    assert names.count("plan") == modes.count("rsc")
    assert names.count("probe") == 30 and names.count("eval") == 4
    parents = {e["name"]: e["parent"] for e in ob.tracer.snapshot()}
    assert parents["plan"] == parents["device_step"] == "step"


# ================================================================== the CLI

SKILL = ["gnn", "--dataset", "reddit", "--scale", "0.003", "--rsc",
         "--epochs", "6", "--block", "32", "--hidden", "24", "--layers",
         "2", "--device", "cpu"]


def test_train_gnn_cli_writes_traces_and_metrics(tmp_path, capsys):
    chrome, jsonl = tmp_path / "t.json", tmp_path / "t.jsonl"
    out = train_cli.main(SKILL + [
        "--metrics", "--metrics-port", "0", "--trace-out", str(chrome),
        "--trace-jsonl", str(jsonl), "--probe-every", "2",
        "--strict-budget", "--slo", "p99_ms=1e6"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[obs] metrics exposition at http://")
    report = json.loads(lines[-1])
    assert {"metrics", "ledger", "slo"} <= set(report)
    assert "sentinel" not in report and "compiles" not in report
    assert report["metrics"]["histograms"]["engine.step_ms{mode=rsc}"][
        "count"] > 0
    assert report["ledger"]["epochs"] == 6
    assert report["ledger"]["violations"] == 0
    assert report["slo"]["objectives"]["p99_ms"]["ok"]
    ev = json.loads(chrome.read_text())["traceEvents"]
    spans = {e["name"] for e in ev if e["ph"] == "X"}
    assert {"step", "plan", "device_step", "eval", "probe"} <= spans
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert sum(r["name"] == "probe" for r in recs) == 3   # epochs 0, 2, 4
    assert out["result"]["ledger"] == report["ledger"]


def test_train_lm_cli_metrics(capsys):
    train_cli.main(["lm", "--arch", "qwen3-1.7b", "--smoke", "--steps", "2",
                    "--device", "cpu", "--metrics"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report["metrics"]) == {"counters", "gauges", "histograms"}


def test_serve_gnn_cli_ckpt_metrics_and_slo(tmp_path, capsys):
    """``serve_gnn --ckpt-dir`` serves the checkpointed parameters; the
    query histogram counts every query batch; the SLO report is there."""
    d = tmp_path / "ck"
    train_out = train_cli.main(SKILL)
    tr = train_out["trainer"]
    from repro_torch.checkpoint import Checkpointer
    Checkpointer(d).save(6, convert.gnn_state_tree(
        tr.params, tr.engine.opt_state), blocking=True)
    capsys.readouterr()
    argv = ["--dataset", "reddit", "--scale", "0.003", "--layers", "2",
            "--hidden", "24", "--block", "32", "--device", "cpu",
            "--queries", "40", "--query-batch", "16", "--ckpt-dir", str(d),
            "--metrics", "--slo", "p99_ms=1e6"]
    out, server = serve_gnn.run(serve_gnn.build_parser().parse_args(argv))
    assert "[serve] restored params from step 6" in capsys.readouterr().out
    for (n, a), (_, b) in zip(tr.params.named_parameters(),
                              server.si.params.named_parameters()):
        assert torch.equal(a, b), n
    h = out["metrics"]["histograms"]["serve.query_ms{replica=r0}"]
    assert h["count"] == out["query_batches"] == 3
    assert out["metrics"]["counters"]["serve.queries{replica=r0}"] == 40
    assert "serve.build_seconds{replica=r0}" in out["metrics"]["gauges"]
    assert out["slo"]["objectives"]["p99_ms"]["ok"]
