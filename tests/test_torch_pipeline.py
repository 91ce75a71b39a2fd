"""The minibatch pipeline of the port against the reference.

* ``build_pool`` (random-walk and LDG pools, GraphSAINT λ/α on and off,
  Ã and D⁻¹A operands): tiles, ids, planner metadata, Frobenius norms,
  loss weights, bucket shapes, node lists and the pool-level arrays are
  bit-identical to ``repro``'s, and so are ``pad_to`` / ``pad_block_meta``
  and the GraphSAINT walks and coefficients.
* ``PlanCachePool`` fed the same ∇H norms over one visit schedule gives
  identical plans and the same hit / cold / refresh counts.
* ``Prefetcher``: the schedule's order, resident hits, and the reference's
  operands, with the prefetch thread and without.
* ``pooled_evaluate`` equals the reference's within 1e-6.
* Minibatch trajectories of GCN and GraphSAGE from the reference's
  initial parameters (dropout 0): the same subgraph order, identical plans
  at every step, losses within ``TRAJ_RTOL``.
* ``eval_mode="stream"`` gives the reference ``StreamEvaluator``'s
  val/test on the same parameters.

All on the CPU, on synthetic Reddit at ``--scale`` 0.004 (932 nodes),
block 32, 2 layers of 48, 4 subgraphs.
"""
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs.datasets import load_dataset as jax_load_dataset
from repro.graphs.saint import random_walk_subgraph as jax_random_walk
from repro.infer.stream import StreamConfig as JaxStreamConfig
from repro.infer.stream import StreamEvaluator as JaxStreamEvaluator
from repro.pipeline import MinibatchConfig as JaxMinibatchConfig
from repro.pipeline import MinibatchTrainer as JaxMinibatchTrainer
from repro.pipeline import PlanCachePool as JaxPlanCachePool
from repro.pipeline import PoolConfig as JaxPoolConfig
from repro.pipeline import Prefetcher as JaxPrefetcher
from repro.pipeline import build_pool as jax_build_pool
from repro.pipeline import pooled_evaluate as jax_pooled_evaluate
from repro.sparse.bcoo import pad_block_meta as jax_pad_block_meta
from repro.train.metrics import metric_fn as jax_metric_fn
from repro_torch import convert
from repro_torch.graphs.datasets import load_dataset
from repro_torch.graphs.saint import random_walk_subgraph
from repro_torch.models.gnn import MODELS
from repro_torch.pipeline import (MinibatchConfig, MinibatchTrainer,
                                  PlanCachePool, PoolConfig, Prefetcher,
                                  build_pool, device_operands, ldg_partition,
                                  make_buckets, pooled_evaluate)
from repro_torch.sparse.bcoo import pad_block_meta
from repro_torch.train.metrics import metric_fn

SCALE = 0.004
POOL = dict(n_subgraphs=4, roots=50, walk_length=2, n_buckets=2, block=32,
            seed=0)
TRAJ = dict(n_layers=2, hidden=48, block=32, batchnorm=True, dropout=0.0,
            rsc=True, budget=0.3, epochs=6, n_subgraphs=4, roots=50,
            walk_length=2, n_buckets=2, autotune=False, seed=0)
TRAJ_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per module: at this size the threads buy
    nothing, and under the suite's parallel workers they contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return load_dataset("reddit", scale=SCALE, seed=0)


@pytest.fixture(scope="module")
def jgraph():
    return jax_load_dataset("reddit", scale=SCALE, seed=0)


# --------------------------------- pools -----------------------------------

def _same_host_bcoo(ours, ref):
    for f in ("blocks", "row_ids", "col_ids", "row_ptr"):
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("bm", "bk", "n_rows", "n_cols", "n_row_blocks",
              "n_col_blocks", "s_total"):
        assert getattr(ours, f) == getattr(ref, f), f


def _same_meta(ours, ref):
    for f in ("row_ids", "col_ids", "col_block_tiles", "col_block_norm",
              "col_nnz", "col_norm"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _same_pool(ours, ref):
    assert [vars(b) for b in ours.buckets] == [vars(b) for b in ref.buckets]
    assert len(ours) == len(ref)
    for f in ("num_classes", "multilabel", "feat_dim", "mean_agg", "block",
              "n_nodes"):
        assert getattr(ours, f) == getattr(ref, f), f
    for f in ("node_labels", "node_val_mask", "node_test_mask"):
        assert np.array_equal(getattr(ours, f), getattr(ref, f)), f
    for a, b in zip(ours.subgraphs, ref.subgraphs):
        for f in ("sub_id", "bucket_id", "n_valid", "fro"):
            assert getattr(a, f) == getattr(b, f), f
        _same_host_bcoo(a.prop, b.prop)
        _same_host_bcoo(a.prop_t, b.prop_t)
        _same_meta(a.meta, b.meta)
        for f in ("nodes", "features", "labels", "train_mask", "val_mask",
                  "test_mask", "loss_w"):
            x, y = getattr(a, f), getattr(b, f)
            if y is None:
                assert x is None, f
            else:
                assert x.dtype == y.dtype and np.array_equal(x, y), f
    if ref.saint is None:
        assert ours.saint is None
    else:
        for f in ("node_counts", "edge_keys", "edge_counts"):
            assert np.array_equal(getattr(ours.saint, f),
                                  getattr(ref.saint, f)), f
        assert ours.saint.n_samples == ref.saint.n_samples


@pytest.mark.parametrize("mean_agg", [False, True])
@pytest.mark.parametrize("saint_norm", [True, False])
@pytest.mark.parametrize("method", ["random_walk", "ldg"])
def test_build_pool_matches_reference(graph, jgraph, method, saint_norm,
                                      mean_agg):
    cfg = dict(POOL, method=method, saint_norm=saint_norm)
    ours = build_pool(graph, PoolConfig(**cfg), mean_agg=mean_agg)
    ref = jax_build_pool(jgraph, JaxPoolConfig(**cfg), mean_agg=mean_agg)
    _same_pool(ours, ref)
    assert (ours.subgraphs[0].loss_w is not None) == saint_norm
    if method == "ldg":            # disjoint parts covering the graph
        nodes = np.concatenate([s.nodes for s in ours.subgraphs])
        assert np.array_equal(np.sort(nodes), np.arange(graph.n))


def test_random_walk_and_ldg_draws_match_reference(graph, jgraph):
    a = random_walk_subgraph(graph, 60, 3, np.random.default_rng(7))
    b = jax_random_walk(jgraph, 60, 3, np.random.default_rng(7))
    assert np.array_equal(a.nodes, b.nodes)
    assert np.array_equal(a.adj.col, b.adj.col)
    assert np.array_equal(a.adj.val, b.adj.val)
    from repro.pipeline import ldg_partition as jax_ldg
    for x, y in zip(ldg_partition(graph.adj, 3, np.random.default_rng(1)),
                    jax_ldg(jgraph.adj, 3, np.random.default_rng(1))):
        assert np.array_equal(x, y)


def test_make_buckets_matches_reference():
    from repro.pipeline import make_buckets as jax_make_buckets
    shapes = [(5, 40), (3, 20), (5, 38), (4, 31), (6, 51), (3, 19)]
    for nb in (1, 2, 3, 10):
        buckets, assign = make_buckets(shapes, nb)
        jb, ja = jax_make_buckets(shapes, nb)
        assert [vars(b) for b in buckets] == [vars(b) for b in jb]
        assert np.array_equal(assign, ja)


def test_pad_to_and_meta_match_reference(graph, jgraph):
    ours = build_pool(graph, PoolConfig(**dict(POOL, n_buckets=1)))
    ref = jax_build_pool(jgraph, JaxPoolConfig(**dict(POOL, n_buckets=1)))
    sub, jsub = ours.subgraphs[0], ref.subgraphs[0]
    n = sub.prop.n_row_blocks
    _same_host_bcoo(sub.prop.pad_to(n + 2, sub.prop.s_total + 7),
                    jsub.prop.pad_to(n + 2, jsub.prop.s_total + 7))
    assert sub.prop.pad_to(n, sub.prop.s_total) is sub.prop
    _same_meta(pad_block_meta(sub.meta, n + 3),
               jax_pad_block_meta(jsub.meta, n + 3))
    with pytest.raises(ValueError, match="smaller than"):
        sub.prop.pad_to(n - 1, sub.prop.s_total)
    with pytest.raises(ValueError, match="shrink"):
        pad_block_meta(sub.meta, sub.meta.col_block_tiles.shape[0] - 1)


# ------------------------------- plan pool ---------------------------------

def _plan_arrays(p, to_np):
    return (tuple(to_np(getattr(p, f)) for f in
                  ("sel", "row_ids", "col_ids", "row_ptr")),
            int(p.n_active), p.s_pad)


def _same_plans(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ours:
        assert all(np.array_equal(a, b)
                   for a, b in zip(ours[k][0], ref[k][0])), k
        assert ours[k][1:] == ref[k][1:], k


def test_plan_cache_pool_matches_reference(graph, jgraph):
    pool = build_pool(graph, PoolConfig(**POOL))
    jpool = jax_build_pool(jgraph, JaxPoolConfig(**POOL))
    module = MODELS["gcn"]
    names = module.spmm_names(2)
    dims = module.spmm_dims(2, 48, pool.num_classes)
    kw = dict(budget_frac=0.3, step_frac=0.02, strategy="greedy",
              refresh_every=2)
    ours = PlanCachePool(pool, names, dims, device="cpu", **kw)
    ref = JaxPlanCachePool(jpool, names, dims, **kw)
    rng = np.random.default_rng(5)
    schedule = [0, 1, 0, 2, 0, 1, 3, 0, 2, 1, 0, 3, 3, 0]
    n_sampled = 0
    for sid in schedule:
        a = ours.plans_for(pool.subgraphs[sid])
        b = ref.plans_for(jpool.subgraphs[sid])
        pa = {k: _plan_arrays(p, lambda t: t.numpy()) for k, p in a.items()}
        pb = {k: _plan_arrays(p, np.asarray) for k, p in b.items()}
        _same_plans(pa, pb)
        n_sampled += sum(v[1] < v[2] - pool.buckets[0].n_blocks
                         for v in pa.values())
        # every plan of a bucket has the bucket's fixed length
        assert {v[2] for v in pa.values()} == {
            pool.buckets[pool.subgraphs[sid].bucket_id].plan_pad}
        n_pad = pool.subgraphs[sid].features.shape[0]
        norms = {k: rng.random(n_pad).astype(np.float32) for k in names}
        ours.record_norms(sid, {k: torch.from_numpy(v)
                                for k, v in norms.items()})
        ref.record_norms(sid, norms)
    assert vars(ours.stats) == vars(ref.stats)
    assert ours.stats.cold == 4 and ours.stats.refreshes > 0 \
        and ours.stats.hits > 0
    assert n_sampled > 0
    assert ours.flops_fraction() == ref.flops_fraction()
    s = ours.summary()
    assert s["hits"] == ref.summary()["hits"]
    assert s["subgraphs"] == [0, 1, 2, 3]


# ------------------------------- prefetcher --------------------------------

@pytest.fixture(scope="module")
def pools(graph, jgraph):
    return (build_pool(graph, PoolConfig(**POOL)),
            jax_build_pool(jgraph, JaxPoolConfig(**POOL)))


@pytest.mark.parametrize("enabled", [True, False])
def test_prefetcher_order_and_resident_hits(pools, enabled):
    pool, jpool = pools
    schedule = [2, 0, 2, 0, 1, 0, 3, 3]
    fetch = Prefetcher(pool, schedule, device="cpu", enabled=enabled,
                       resident=2)
    got = [(sid, ops) for sid, ops in fetch]
    assert [sid for sid, _ in got] == schedule
    # LRU of 2: hits at the second 2, the second and third 0, the second 3
    assert fetch.resident_hits == 4 and fetch.uploads == 4
    assert got[2][1] is got[0][1]
    # the reference's operands, array for array
    jfetch = JaxPrefetcher(jpool, schedule, enabled=enabled)
    for (sid, ops), (jsid, jops) in zip(got, jfetch):
        assert sid == jsid
        for f in ("a", "at"):
            for g in ("blocks", "row_ids", "col_ids", "row_ptr"):
                assert np.array_equal(getattr(getattr(ops, f), g).numpy(),
                                      np.asarray(getattr(getattr(jops, f),
                                                         g))), (f, g)
        assert ops.am is ops.a and ops.amt is ops.at
        for f in ("features", "labels", "train_mask", "val_mask",
                  "test_mask", "loss_w"):
            assert np.array_equal(getattr(ops, f).numpy(),
                                  np.asarray(getattr(jops, f))), f
        assert ops.n_valid == int(jops.n_valid)


def test_prefetcher_shares_cache_and_raises_worker_errors(pools):
    pool = pools[0]
    cache = OrderedDict()
    list(Prefetcher(pool, [0, 1], device="cpu", resident=2, cache=cache))
    again = Prefetcher(pool, [1, 0], device="cpu", resident=2, cache=cache)
    assert [sid for sid, _ in again] == [1, 0]
    assert again.uploads == 0 and again.resident_hits == 2
    with pytest.raises(IndexError):
        list(Prefetcher(pool, [0, 99], device="cpu"))
    ops = device_operands(pool, pool.subgraphs[1], "cpu")
    assert ops.a.s_total == pool.buckets[pool.subgraphs[1].bucket_id].s_pad


# ---------------------------- pooled evaluation ----------------------------

def test_pooled_evaluate_matches_reference(pools):
    pool, jpool = pools
    w = np.random.default_rng(3).standard_normal(
        (pool.feat_dim, pool.num_classes)).astype(np.float32)
    ours = pooled_evaluate(pool, lambda p, ops: ops.features @ p,
                           metric_fn("accuracy"), torch.from_numpy(w),
                           device="cpu")
    ref = jax_pooled_evaluate(jpool, lambda p, ops: ops.features @ p,
                              jax_metric_fn("accuracy"), jnp.asarray(w))
    assert abs(ours[0] - ref[0]) <= 1e-6 and abs(ours[1] - ref[1]) <= 1e-6
    # shared nodes are scored once: the pool covers fewer nodes than the
    # subgraphs hold together
    assert sum(s.n_valid for s in pool.subgraphs) > len(
        np.unique(np.concatenate([s.nodes for s in pool.subgraphs])))


# ------------------------------- trajectories ------------------------------

def _capture(planner, to_np):
    """Record each RSC step's plans (as numpy)."""
    plans = []
    plans_for = planner.plans_for

    def wrapped(tag, step, schedule):
        out = plans_for(tag, step, schedule)
        plans.append({k: _plan_arrays(p, to_np) for k, p in out.items()})
        return out

    planner.plans_for = wrapped
    return plans


@pytest.fixture(scope="module")
def reference_runs(jgraph):
    """The reference's minibatch runs (and initial params) per model."""
    out = {}
    for model in ("gcn", "graphsage"):
        tr = JaxMinibatchTrainer(
            JaxMinibatchConfig(model=model, backend="jnp", **TRAJ), jgraph)
        init = jax.device_get(tr.engine.params)
        plans = _capture(tr.engine.planner, np.asarray)
        res = tr.train(eval_every=3)
        out[model] = (init, res, plans, tr.engine.planner.plan_pool.stats)
    return out


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_minibatch_trajectory_matches_reference(graph, reference_runs,
                                                model):
    init, jres, jplans, jstats = reference_runs[model]
    tr = MinibatchTrainer(
        MinibatchConfig(model=model, backend="kernel", device="cpu", **TRAJ),
        graph, model=convert.gnn_params_from_numpy(model, init,
                                                   device="cpu"))
    plans = _capture(tr.engine.planner, lambda t: t.numpy())
    res = tr.train(eval_every=3)
    hist, jhist = res["history"], jres["history"]
    assert hist["sub_id"] == jhist["sub_id"] and len(hist["sub_id"]) == 24
    assert hist["mode"] == jhist["mode"]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=TRAJ_RTOL)
    assert len(plans) == len(jplans) == hist["mode"].count("rsc")
    for ours, ref in zip(plans, jplans):
        _same_plans(ours, ref)
    assert vars(res["cache_stats"]) == vars(jstats)
    assert res["plan_hit_rate"] == jres["plan_hit_rate"]
    assert res["flops_fraction"] == jres["flops_fraction"] < 1.0
    assert res["n_buckets"] == jres["n_buckets"] == 2
    for (e, v), (je, jv) in zip(hist["val"], jhist["val"]):
        assert e == je and abs(v - jv) <= 1e-6


def test_stream_evaluation_matches_reference(graph, jgraph, reference_runs):
    init = reference_runs["gcn"][0]
    cfg = MinibatchConfig(model="gcn", backend="kernel", device="cpu",
                          eval_mode="stream", stream_partitions=3, **TRAJ)
    tr = MinibatchTrainer(cfg, graph, model=convert.gnn_params_from_numpy(
        "gcn", init, device="cpu"))
    ours = tr.evaluate()
    assert tr.engine.stream_eval.si.n_partitions == 3
    ref = JaxStreamEvaluator(jgraph, "gcn", JaxStreamConfig(
        block=32, n_partitions=3, memory_budget_mb=None, backend="jnp"))
    jv = ref.evaluate(init, jax_metric_fn("accuracy"))
    assert ours == pytest.approx(jv, abs=1e-6)
    # built once, reused
    si = tr.engine.stream_eval.si
    tr.evaluate()
    assert tr.engine.stream_eval.si is si and tr.engine.stream_eval.evals == 2


def test_stream_evaluation_needs_the_graph(pools):
    with pytest.raises(ValueError, match="full graph"):
        MinibatchTrainer(MinibatchConfig(device="cpu", eval_mode="stream",
                                         **TRAJ), pool=pools[0])


def test_dp_raises_naming_its_item(pools):
    """A prebuilt pool whose buckets (2 and 2 subgraphs) do not split
    across 4 shards raises the reference's error naming the bucket; a
    pool that splits still needs the rank's process group."""
    with pytest.raises(ValueError, match="bucket 0 holds 2 subgraphs"):
        MinibatchTrainer(MinibatchConfig(device="cpu", dp=4, **TRAJ),
                         pool=pools[0])
    with pytest.raises(ValueError, match="DPGroup"):
        MinibatchTrainer(MinibatchConfig(device="cpu", dp=2, **TRAJ),
                         pool=pools[0])


def test_dp_pool_from_graph_rebuilds_single_bucket(graph):
    """Built from the graph, a pool whose buckets do not split across the
    shards is rebuilt with one bucket, as the reference does."""
    from repro_torch.pipeline import dp_pool, shard_pool_ids
    cfg = MinibatchConfig(device="cpu", dp=4, **TRAJ)
    pool = dp_pool(cfg, graph=graph)
    assert len(pool.buckets) == 1 and len(pool) == 4
    assert shard_pool_ids(pool, 4) == [[0], [1], [2], [3]]


def test_minibatch_defaults_to_cuda(pools):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MinibatchTrainer(MinibatchConfig(**TRAJ), pool=pools[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(Prefetcher(pools[0], [0]))
