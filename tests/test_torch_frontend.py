"""The port's serving frontend against the reference: the write-ahead
``UpdateLog``, replicas behind the batching dispatcher (consistent with a
bare server, serving through a replica's rebuild, warm-started from the
first), versioned snapshots that queries read without blocking, the
sampled replica's routing and its bootstrap CI, ``LabelCap``, the
slowest-K ``TailLog`` and ``/debug/slow``, and a graceful ``close``.

Graph and model are the reference tests' (``sbm_graph(n_nodes=500,
n_clusters=5, avg_degree=10, feat_dim=16)``, GCN 2 × 32, block 32, 3
partitions), the parameters the reference's seeded init carried over with
``convert.gnn_params_from_numpy``; the reference runs ``jnp``, the port
the kernel's plain version on the CPU. Logits against the reference: atol
1e-5·max|logit| (rtol 0; the two sum the same f32 products in other
orders); within the port, bit for bit. Every wait on a thread passes a
timeout and asserts on it; no assertion rests on a sleep.
"""
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
from repro.infer import NodeServer as JaxNodeServer
from repro.infer import ServeFrontend as JaxServeFrontend
from repro.infer import StreamConfig as JaxStreamConfig
from repro.infer import UpdateLog as JaxUpdateLog
from repro.infer.frontend import LabelCap as JaxLabelCap
from repro.models.gnn import MODELS as JAX_MODELS
from repro.obs.taillog import TailLog as JaxTailLog
from repro_torch import obs
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.infer import (NodeServer, QueryResult, ServeFrontend,
                               StreamConfig, UpdateLog)
from repro_torch.infer.frontend import LabelCap
from repro_torch.obs.export import MetricsExporter
from repro_torch.obs.taillog import TailLog

from tests.test_torch_gnn_train import one_torch_thread  # noqa: F401

GRAPH = dict(n_nodes=500, n_clusters=5, avg_degree=10, feat_dim=16, seed=0)
CFG = dict(block=32, n_partitions=3, memory_budget_mb=None)
WAIT = 60.0      # seconds any wait on a serving thread may take


@pytest.fixture(scope="module")
def graphs():
    return sbm_graph(**GRAPH), jax_sbm_graph(**GRAPH)


@pytest.fixture(scope="module")
def params():
    tree = jax.device_get(JAX_MODELS["gcn"].init(
        jax.random.PRNGKey(0), 16, 32, 5, 2, False))
    return tree, gnn_params_from_numpy("gcn", tree, "cpu")


def _cfg(**kw):
    return StreamConfig(device="cpu", **dict(CFG, **kw))


def _close(ours, ref):
    """Within atol 1e-5·max|logit|, rtol 0."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def _edge(g):
    hub = int(np.argmax(g.adj.row_nnz()))
    return hub, int(g.adj.col[g.adj.rowptr[hub]])


def _stall(srv):
    """Make ``srv``'s next recompute wait for a release; returns the
    (entered, release) events."""
    entered, release = threading.Event(), threading.Event()
    orig = srv.si.recompute_rows

    def blocking(*a, **k):
        entered.set()
        assert release.wait(WAIT)
        return orig(*a, **k)

    srv.si.recompute_rows = blocking
    return entered, release


# ------------------------------------------------------------- pieces

def test_update_log_sequencing_matches_reference():
    ours, ref = UpdateLog(), JaxUpdateLog()
    assert ours.latest_seq == 0 and ours.since(0) == []
    for add, remove in [([(0, 1)], []), ([], [(2, 3)]),
                        ([(4, 5), (6, 7)], [(1, 0)])]:
        assert ours.append(add, remove) == ref.append(add, remove)
    assert ours.latest_seq == ref.latest_seq == 3
    for seq in range(4):
        a, b = ours.since(seq), ref.since(seq)
        assert len(a) == len(b) == 3 - seq
        for (s1, a1, r1, c1), (s2, a2, r2, c2) in zip(a, b):
            assert s1 == s2 and c1 is None and c2 is None
            np.testing.assert_array_equal(a1, a2)
            np.testing.assert_array_equal(r1, r2)
            assert a1.dtype == np.int64 and a1.shape[1] == 2


def test_label_cap_matches_reference():
    names = ["a", "b", "a", "c", "d", "b", "e", "c"]
    for limit in (1, 2, 8):
        ours, ref = LabelCap(limit=limit), JaxLabelCap(limit=limit)
        assert [ours(n) for n in names] == [ref(n) for n in names]
    cap = LabelCap(limit=2)
    assert [cap(v) for v in ["a", "b", "a", "c", "d", "b"]] == \
        ["a", "b", "a", "other", "other", "b"]


@pytest.mark.parametrize("k", [1, 4, 16])
def test_taillog_snapshots_match_reference(k):
    """The same offers give the reference's snapshots, thresholds and
    verdicts (ties keep the earlier request)."""
    rng = np.random.default_rng(k)
    ms = np.round(rng.exponential(5.0, 200), 1)   # rounding makes ties
    ours, ref = TailLog(k=k), JaxTailLog(k=k)
    for i, t in enumerate(ms):
        rec = {"trace_id": f"t{i}", "phases": {"queue_ms": float(t) / 2}}
        assert ours.offer(t, dict(rec)) == ref.offer(t, dict(rec))
        assert ours.threshold_ms() == ref.threshold_ms()
        if i % 50 == 0:
            assert ours.snapshot() == ref.snapshot()
    snap = ours.snapshot()
    assert snap == ref.snapshot() and len(ours) == snap["kept"] == k
    assert snap["offered"] == 200
    assert [r["total_ms"] for r in snap["slow"]] == \
        sorted((round(float(t), 3) for t in ms), reverse=True)[:k]
    ours.clear()
    assert len(ours) == 0 and ours.snapshot()["offered"] == 0


def test_debug_slow_endpoint():
    """``/debug/slow`` serves the attached tail log's snapshot (404 until
    one is attached)."""
    tl = TailLog(k=2)
    for t in (3.0, 9.0, 1.0):
        tl.offer(t, {"replica": "r0"})
    with MetricsExporter(port=0) as ex:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{ex.url}/debug/slow", timeout=WAIT)
        e.value.close()
        assert e.value.code == 404
        ex.attach(taillog=tl)
        with urllib.request.urlopen(f"{ex.url}/debug/slow",
                                    timeout=WAIT) as r:
            assert r.headers["Content-Type"] == "application/json"
            got = json.loads(r.read())
    assert got == tl.snapshot()
    assert [x["total_ms"] for x in got["slow"]] == [9.0, 3.0]


# ---------------------------------------------------------- snapshots

def test_snapshot_versions_refcounted(graphs, params):
    """A pinned version survives the next publication and still answers;
    releasing it drops it; the new version answers as the reference's
    server after the same update does."""
    g, r = graphs
    tree, net = params
    srv = NodeServer(g, "gcn", net, _cfg())
    ids = np.arange(g.n)
    pre = srv.query(ids)
    old = srv.acquire_snapshot()
    assert old.version == 0 and old.applied_seq == 0
    hub, nbr = _edge(g)
    st = srv.update_edges(remove=[(hub, nbr)])
    assert st["version"] == 1 and srv.version == 1
    assert old in srv._retired and srv.stats()["retired_versions_live"] == 1
    np.testing.assert_array_equal(old.logits[srv.si.pos[ids]], pre)
    post, meta = srv.query(ids, with_meta=True)
    assert meta[:2] == (1, 1) and meta[2] > 0.0
    assert not np.array_equal(post, pre)
    srv.release_snapshot(old)
    assert not srv._retired and srv.versions_dropped == 1
    jsrv = JaxNodeServer(r, "gcn", tree, JaxStreamConfig(**CFG))
    jsrv.update_edges(remove=[(hub, nbr)])
    _close(post, jsrv.query(ids))
    phases = {}
    srv.query(ids[:5], phases=phases)
    assert set(phases) == {"pin_ms", "gather_ms"}
    assert srv.update_edges() == {"edges": 0, "dirty_nodes": 0,
                                  "seconds": 0.0, "version": 1}


def test_queries_never_block_on_updates(graphs, params):
    """A query issued while an update is mid-recompute returns the
    COMPLETE previous snapshot at once."""
    g, _ = graphs
    srv = NodeServer(g, "gcn", params[1], _cfg())
    ids = np.arange(g.n)
    pre = srv.query(ids)
    hub, nbr = _edge(g)
    entered, release = _stall(srv)
    err = []

    def do_update():
        try:
            srv.update_edges(remove=[(hub, nbr)])
        except BaseException as e:   # pragma: no cover
            err.append(e)

    t = threading.Thread(target=do_update)
    t.start()
    try:
        assert entered.wait(WAIT)
        for _ in range(3):
            np.testing.assert_array_equal(srv.query(ids), pre)
        assert srv.version == 0
    finally:
        release.set()
        t.join(WAIT)
    assert not t.is_alive() and not err and srv.version == 1
    fresh = NodeServer(g, "gcn", params[1], _cfg())
    fresh.update_edges(remove=[(hub, nbr)])
    np.testing.assert_array_equal(srv.query(ids), fresh.query(ids))


def test_warm_start_shares_the_first_replicas_snapshot(graphs, params):
    """``warm_from`` shares the source's immutable arrays instead of
    running a forward; the first update copies them (the source's
    snapshot is untouched) and both replicas publish the same bits."""
    g, _ = graphs
    a = NodeServer(g, "gcn", params[1], _cfg(), name="r0")
    b = NodeServer(g, "gcn", params[1], _cfg(), warm_from=a, name="r1")
    assert b.si.logits is a.si.logits
    assert all(x is y for x, y in zip(b.si.layer_store, a.si.layer_store))
    snap_a = a.acquire_snapshot()
    before = snap_a.logits.copy()
    hub, nbr = _edge(g)
    b.update_edges(remove=[(hub, nbr)], seq=7)
    np.testing.assert_array_equal(snap_a.logits, before)
    a.release_snapshot(snap_a)
    a.update_edges(remove=[(hub, nbr)], seq=7)
    np.testing.assert_array_equal(a.si.logits, b.si.logits)
    assert a.applied_seq == b.applied_seq == 7
    with pytest.raises(ValueError, match="sampled mode"):
        NodeServer(g, "gcn", params[1], _cfg(sample_budget=0.5),
                   sampled=True, warm_from=a)


# ------------------------------------------------------------ frontend

def test_frontend_replicas_consistent(graphs, params):
    """Batched answers equal a bare server's bit for bit; updates reach
    every replica through the log, versions and ``applied_seq`` rise
    monotonically, the log drains, and the post-update answers equal the
    bare server's after the same updates (and the reference's within
    1e-5·max|logit|)."""
    g, r = graphs
    tree, net = params
    hub, nbr = _edge(g)
    u, v = 11, 300
    ids = np.arange(g.n)
    with ServeFrontend(g, "gcn", net, _cfg(), replicas=2,
                       max_batch=128) as fe:
        bare = NodeServer(g, "gcn", net, _cfg())
        reqs = [fe.submit(ids[i::3]) for i in range(3)]
        for i, req in enumerate(reqs):
            res = req.wait(WAIT)
            assert isinstance(res, QueryResult)
            assert res.staleness == 0 and not res.sampled
            np.testing.assert_array_equal(res.logits, bare.query(ids[i::3]))
            assert {"queue_ms", "batch_ms", "handoff_ms", "pin_ms",
                    "gather_ms", "answer_ms", "total_ms",
                    "wake_ms"} <= set(res.phases)
        seen = []
        for add, remove in [([], [(hub, nbr)]), ([(u, v)], [])]:
            seq = fe.update_edges(add=add, remove=remove, wait=True,
                                  timeout=WAIT)
            assert fe.min_applied_seq() == fe.log.latest_seq == seq
            res = fe.query(ids, timeout=WAIT)
            assert res.applied_seq == seq and res.staleness == 0
            seen.append((res.version, res.applied_seq))
            bare.update_edges(add=add, remove=remove)
            np.testing.assert_array_equal(res.logits, bare.query(ids))
        assert seen == [(1, 1), (2, 2)]
        st = fe.stats()
        assert st["log_seq"] == st["min_applied_seq"] == 2
        assert all(s["applied_seq"] == 2 and s["version"] == 2
                   for s in st["servers"])
        jsrv = JaxNodeServer(r, "gcn", tree, JaxStreamConfig(**CFG))
        jsrv.update_edges(remove=[(hub, nbr)])
        jsrv.update_edges(add=[(u, v)])
        _close(fe.query(ids, timeout=WAIT).logits, jsrv.query(ids))


def test_frontend_serves_during_replica_rebuild(graphs, params):
    """While r0 is stuck mid-rebuild the dispatcher routes around it:
    queries answer from r1's snapshot with an honest staleness count."""
    g, _ = graphs
    hub, nbr = _edge(g)
    ids = np.arange(0, g.n, 7)
    with ServeFrontend(g, "gcn", params[1], _cfg(), replicas=2,
                       max_batch=64) as fe:
        pre = fe.query(ids, timeout=WAIT).logits
        entered, release = _stall(fe.replicas[0])
        try:
            seq = fe.update_edges(remove=[(hub, nbr)])
            assert entered.wait(WAIT)
            for _ in range(3):
                res = fe.query(ids, timeout=WAIT)
                assert res.replica != "r0"      # the locked replica
                assert res.staleness == seq
                np.testing.assert_array_equal(res.logits, pre)
        finally:
            release.set()
        fe.wait_applied(seq, timeout=WAIT)
        res = fe.query(ids, timeout=WAIT)
        assert res.staleness == 0
        fresh = NodeServer(g, "gcn", params[1], _cfg())
        fresh.update_edges(remove=[(hub, nbr)])
        np.testing.assert_array_equal(res.logits, fresh.query(ids))


def test_frontend_sampled_routing_and_ci_match_reference(graphs, params):
    """The sampled replica's relative error and bootstrap CI follow the
    reference's (within 1e-4 relative: the logits differ in their last
    bits; bit for bit on the same logits); ``error_budget`` routes to the
    sampled replica iff it covers the CI's upper bound; updates reach the
    sampled replica through its sampled recompute."""
    g, r = graphs
    tree, net = params
    ids = np.arange(0, g.n, 5)
    with ServeFrontend(g, "gcn", net, _cfg(), replicas=1,
                       sampled_budget=0.7) as fe, \
            JaxServeFrontend(r, "gcn", tree, JaxStreamConfig(**CFG),
                             replicas=1, sampled_budget=0.7) as jfe:
        err, (lo, hi) = fe.sampled_rel_error, fe.sampled_rel_ci
        assert 0.0 <= lo <= err <= hi < float("inf")
        np.testing.assert_allclose([err, lo, hi],
                                   [jfe.sampled_rel_error,
                                    *jfe.sampled_rel_ci], rtol=1e-4)
        _close(fe.sampled_server.si.logits[:g.n],
               np.asarray(jfe.sampled_server.si.logits)[:g.n])
        assert fe.stats()["sampled_rel_ci"] == pytest.approx([lo, hi])
        below = fe.query(ids, error_budget=lo * 0.9, timeout=WAIT)
        assert not below.sampled and below.replica == "r0"
        at = fe.query(ids, error_budget=hi, timeout=WAIT)
        assert at.sampled and at.replica == "sampled"
        assert not np.array_equal(at.logits, below.logits)
        none = fe.query(ids, timeout=WAIT)
        assert not none.sampled
        np.testing.assert_array_equal(none.logits, below.logits)
        # the same logits in both: the probe's arithmetic bit for bit
        for f in (fe, jfe):
            f.replicas[0]._snap.logits = np.asarray(
                jfe.replicas[0]._snap.logits)
            f.sampled_server._snap.logits = np.asarray(
                jfe.sampled_server._snap.logits)
            f._probe_sampled_error()
        assert fe.sampled_rel_error == jfe.sampled_rel_error
        assert fe.sampled_rel_ci == jfe.sampled_rel_ci
        hub, nbr = _edge(g)
        seq = fe.update_edges(remove=[(hub, nbr)], wait=True, timeout=WAIT)
        assert fe.sampled_server.applied_seq == seq
        assert fe.sampled_server.last_update["recompute_chunks"][-1] > 0


def test_frontend_no_sampled_replica_ci_is_inf(graphs, params):
    g, _ = graphs
    with ServeFrontend(g, "gcn", params[1], _cfg(), replicas=1) as fe:
        assert fe.sampled_rel_ci == (float("inf"), float("inf"))
        assert fe.stats()["sampled_rel_ci"] is None
        res = fe.query(np.arange(0, g.n, 9), error_budget=1e9,
                       timeout=WAIT)
        assert not res.sampled


def test_frontend_deadline_tail_log_and_metrics(graphs, params):
    """A request whose deadline passed before dispatch is dropped (a
    TimeoutError naming it, counted); answered requests reach the tail
    log with their phases; the frontend's metrics carry capped replica
    labels."""
    g, _ = graphs
    ob = obs.reset(metrics=True)
    try:
        with ServeFrontend(g, "gcn", params[1], _cfg(), replicas=2,
                           slow_k=2) as fe:
            late = fe.submit(np.arange(4), timeout=-1.0)
            with pytest.raises(TimeoutError, match="deadline exceeded"):
                late.wait(WAIT)
            for i in range(4):
                fe.query(np.arange(i, 40, 4), timeout=WAIT)
            snap = fe.taillog.snapshot()
        reg = ob.registry.snapshot()
    finally:
        obs.reset()
    assert snap["offered"] == 4 and snap["kept"] == 2
    assert all(set(rec["phases"]) >= {"queue_ms", "total_ms"}
               for rec in snap["slow"])
    assert reg["counters"]["frontend.deadline_dropped"] == 1
    assert reg["counters"]["frontend.requests"] == 5
    assert {"frontend.request_ms{replica=r0}",
            "frontend.request_ms{replica=r1}"} <= set(reg["histograms"])


def test_frontend_close_is_graceful(graphs, params):
    """After close(): new submits are refused, close() is idempotent, and
    the dispatcher and updater threads have exited."""
    g, _ = graphs
    fe = ServeFrontend(g, "gcn", params[1], _cfg(), replicas=1,
                       max_batch=4)
    ids = np.arange(16)
    assert fe.query(ids, timeout=WAIT).logits.shape[0] == ids.size
    fe.close()
    fe.close()
    with pytest.raises(RuntimeError, match="frontend closed"):
        fe.submit(ids)
    with pytest.raises(RuntimeError, match="frontend closed"):
        fe.query(ids)
    assert not fe._dispatcher.is_alive() and not fe._updater.is_alive()
    with pytest.raises(ValueError, match="at least one replica"):
        ServeFrontend(g, "gcn", params[1], _cfg(), replicas=0)


def test_query_counters_hold_under_thread_stress(graphs, params):
    """Many threads querying one replica (as the answer pool does) with a
    shortened switch interval: the replica counts every id once."""
    import sys

    g, _ = graphs
    srv = NodeServer(g, "gcn", params[1], _cfg())
    n_threads, calls, ids = 16, 50, np.arange(7)
    errs = []

    def work():
        try:
            for _ in range(calls):
                srv.query(ids)
        except BaseException as e:   # pragma: no cover
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not errs and not any(t.is_alive() for t in ts)
    assert srv.stats()["queries"] == n_threads * calls * ids.size
