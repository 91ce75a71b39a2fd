"""Data-parallel GraphSAINT RSC training of the port against the reference.

* (a) ``compress_int8`` / ``decompress_int8`` / ``ErrorFeedbackCompressor``
  equal ``repro.distributed.compression`` bit for bit: padded sizes,
  blocks of 64 and 128, an all-zero block (the 1e-12 clamp), values
  exactly half a step apart (half to even), bf16 input, 50 steps of error
  feedback, ``bytes_ratio``; and the reference's own cases of
  ``tests/test_checkpoint_distributed.py``.
* (b) The fault policies give the reference's outputs over its cases and
  over random timelines drawn with hypothesis.
* (c) ``shard_pool_ids`` (its errors too) and every rank's column of
  ``ShardedPoolSource.epoch_schedule`` equal the reference's, for dp 2
  and 4, 1 and 2 buckets, over 3 epochs (the reference's source reads
  only ``mesh.shape["data"]``, so a stub stands for its mesh).
* (d)-(g) and the resume run in 2 gloo ranks on the CPU (one spawn for
  all of them, each rank pinned to one thread), beside one subprocess of
  the reference on 2 forced host devices:
  (d) the bucketed all-reduce, 1 to 5 buckets over mixed leaf sizes,
  equals ``_bucketed_pmean`` under ``jax.vmap(axis_name="data")`` bit
  for bit, and the per-leaf mean ``pmean``'s;
  (e) exact-mode DP trajectories (plain, compressed, compressed and
  overlapped) from the reference's initial parameters: the same subgraph
  tuples and ``compress`` history, losses within ``TRAJ_RTOL``, final
  parameters within 1e-5; overlapped equals per leaf bit for bit in the
  port;
  (f) two RSC DP steps on the reference's plans (the cold exact plans,
  then the plans refreshed from the first step's norms) against
  ``runner.rsc_step``: parameters, loss and each rank's norms within
  1e-5;
  (g) a compressed RSC run with switching: each rank's plans equal the
  reference ``PlanCachePool``'s (labelled ``shard{d}``) fed that rank's
  norms, at every RSC step; ``compress`` is on exactly on the RSC steps;
  hit rate above 0, ``flops_fraction`` within the budget;
  resume: stopped after step 5 and restored, the run gives the
  uninterrupted run's losses and parameters bit for bit.
* (h) ``train gnn --minibatch --dp 2 --force-host-devices 2 --device cpu``
  prints the reference's keys; ``--dp 2`` without
  ``--force-host-devices`` on the CPU raises, naming the count.

The reference's DP RSC training cannot run on the installed JAX
(``ShardedPlanner.record`` indexes a sharded array, which JAX 0.9 refuses),
so (f) and (g) hold the port's per-shard planning against the reference's
pieces. Its subprocess gathers every sharded array to the host before
indexing it. The spawned ranks import this module, so JAX and ``repro``
are imported inside the tests only.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import convert
from repro_torch.distributed import (ErrorFeedbackCompressor, HeartbeatTracker,
                                     RestartPolicy, StragglerMonitor,
                                     compress_int8, decompress_int8, launch,
                                     parse_mesh_spec, plan_group)
from repro_torch.distributed.elastic import replicate_tree, reshard_tree
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.launch import train as train_cli
from repro_torch.models.gnn import MODELS
from repro_torch.pipeline import (MinibatchConfig, MinibatchTrainer,
                                  PoolConfig, ShardedPoolSource, build_pool,
                                  device_operands, dp_pool, shard_pool_ids)

ROOT = Path(__file__).resolve().parents[1]
TRAJ_RTOL = 1e-5       # tests/test_torch_pipeline.py's
GRAPH = dict(n_nodes=400, n_clusters=4, avg_degree=10, feat_dim=12, seed=0)
COMMON = dict(model="gcn", n_layers=2, hidden=24, block=32, dropout=0.0,
              epochs=2, seed=3, n_subgraphs=8, method="random_walk",
              roots=50, walk_length=3, n_buckets=2, autotune=False,
              budget=0.3, refresh_every=2)
RUNS = {"plain": {}, "compress": {"compress_grads": True},
        "overlap": {"compress_grads": True, "overlap_allreduce": True,
                    "overlap_buckets": 3}}
# a pool whose two buckets hold 3 subgraphs each: they do not split in 2
ODD_POOL = dict(n_subgraphs=6, roots=50, walk_length=3, n_buckets=2,
                block=32, seed=0)
# mixed leaf sizes for the bucket test: one leaf of 1, odd sizes, a matrix
LEAF_SHAPES = {"a": (7,), "b": (33, 5), "c": (1,), "d": (128,),
               "e": (3, 40), "f": (257,)}
CLI_ARGV = ["gnn", "--minibatch", "--scale", "0.004", "--block", "32",
            "--hidden", "48", "--layers", "2", "--subgraphs", "4",
            "--roots", "50", "--walk-length", "2", "--epochs", "4", "--rsc",
            "--no-autotune"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per module: at this size threads buy nothing
    and contend for the cores under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- (a) codec

def _codec_case(name: str, rng) -> np.ndarray:
    if name == "padded":
        return rng.standard_normal(1000).astype(np.float32)
    if name == "zero_block":
        g = rng.standard_normal(300).astype(np.float32)
        g[128:256] = 0.0
        return g
    if name == "half_steps":
        # max 127 → scale exactly 1: codes at k + 0.5 round half to even
        g = np.arange(-63.5, 64.0, 1.0, dtype=np.float32)
        g[0] = 127.0
        return g
    return rng.standard_normal((33, 7)).astype(np.float32)


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("case", ["padded", "zero_block", "half_steps",
                                  "matrix"])
def test_int8_codec_matches_reference_bit_for_bit(case, block):
    import jax.numpy as jnp
    from repro.distributed.compression import compress_int8 as jc
    from repro.distributed.compression import decompress_int8 as jd
    g = _codec_case(case, np.random.default_rng(block))
    codes, scales = compress_int8(torch.from_numpy(g), block)
    jcodes, jscales = jc(jnp.asarray(g), block)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert np.array_equal(scales.numpy(), np.asarray(jscales))
    deq = decompress_int8(codes, scales, g.shape)
    assert np.array_equal(deq.numpy(),
                          np.asarray(jd(jcodes, jscales, g.shape)))
    if case == "zero_block":
        assert float(scales[128 // block]) == np.float32(1e-12)
    if case == "half_steps":
        assert float(scales[0]) == 1.0 and set(
            codes.numpy()[0, 1:4].tolist()) <= {-62, -60, -58}


def test_int8_codec_bf16_matches_reference():
    import jax.numpy as jnp
    from repro.distributed.compression import ErrorFeedbackCompressor as JEF
    g = np.random.default_rng(2).standard_normal(500).astype(np.float32)
    ours, jref = ErrorFeedbackCompressor(128), JEF(128)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    jg = jnp.asarray(g, jnp.bfloat16)
    deq, err = ours.compress({"w": tg}, ours.init({"w": tg}))
    jdeq, jerr = jref.compress({"w": jg}, jref.init({"w": jg}))
    assert deq["w"].dtype == torch.bfloat16
    assert np.array_equal(deq["w"].float().numpy(),
                          np.asarray(jdeq["w"], np.float32))
    assert np.array_equal(err["w"].numpy(), np.asarray(jerr["w"]))


def test_error_feedback_50_steps_matches_reference():
    import jax.numpy as jnp
    from repro.distributed.compression import ErrorFeedbackCompressor as JEF
    rng = np.random.default_rng(1)
    ours, jref = ErrorFeedbackCompressor(block=64), JEF(block=64)
    shapes = {"w": (256,), "v": (13, 11)}
    err = ours.init({k: torch.zeros(s) for k, s in shapes.items()})
    jerr = jref.init({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(50):
        g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in shapes.items()}
        cg, err = ours.compress({k: torch.from_numpy(v)
                                 for k, v in g.items()}, err)
        jcg, jerr = jref.compress({k: jnp.asarray(v)
                                   for k, v in g.items()}, jerr)
        for k in shapes:
            assert np.array_equal(cg[k].numpy(), np.asarray(jcg[k])), k
            assert np.array_equal(err[k].numpy(), np.asarray(jerr[k])), k


def test_bytes_ratio_matches_reference():
    import jax.numpy as jnp
    from repro.distributed.compression import ErrorFeedbackCompressor as JEF
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        for block in (64, 128):
            assert ErrorFeedbackCompressor.bytes_ratio(tdt, block) == \
                JEF.bytes_ratio(jdt, block)
    assert ErrorFeedbackCompressor.wire_bytes(1000, 128) == 1024 + 4 * 8


# the reference's own cases (tests/test_checkpoint_distributed.py:105-137)
def test_int8_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((1000,)).astype(np.float32))
    codes, scales = compress_int8(g, block=128)
    deq = decompress_int8(codes, scales, g.shape)
    err = (deq - g).abs().max().item()
    assert err <= float(scales.max()) / 2 + 1e-6


def test_error_feedback_converges():
    rng = np.random.default_rng(1)
    ef = ErrorFeedbackCompressor(block=64)
    err = ef.init({"w": torch.zeros(256)})
    true_sum, comp_sum = np.zeros(256), np.zeros(256)
    for _ in range(50):
        g = {"w": torch.from_numpy(
            (rng.standard_normal(256) * 0.1).astype(np.float32))}
        true_sum += g["w"].numpy()
        cg, err = ef.compress(g, err)
        comp_sum += cg["w"].numpy()
    assert np.abs(comp_sum - true_sum).max() < 0.05


def test_compression_ratio():
    assert 0.5 < ErrorFeedbackCompressor.bytes_ratio(torch.bfloat16,
                                                     128) < 0.6


# ------------------------------------------------------- (b) fault policies

def test_heartbeat_detects_dead():
    hb = HeartbeatTracker(4, timeout_s=10)
    for w, t in ((0, 100.0), (1, 100.0), (2, 95.0), (3, 89.0)):
        hb.beat(w, now=t)
    assert hb.dead(now=100.0) == [3]


def test_straggler_monitor_flags_slow_worker():
    mon = StragglerMonitor(4, threshold=1.5, patience=2)
    for _ in range(6):
        evict = mon.observe([1.0, 1.0, 1.0, 3.0])
    assert evict == [3]


def test_straggler_monitor_ignores_transient():
    mon = StragglerMonitor(4, threshold=1.5, patience=3)
    for step in range(10):
        assert mon.observe([1.0, 1.0, 1.0, 3.0 if step == 4 else 1.0]) == []


def test_restart_policy():
    rp = RestartPolicy(min_workers=6)
    assert [rp.plan(a, 8) for a in (8, 7, 5)] == ["continue", "shrink",
                                                  "halt"]


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 6), data=st.data())
def test_fault_policies_match_reference_on_random_timelines(n, data):
    from repro.distributed import fault as jfault
    steps = data.draw(st.lists(st.lists(
        st.floats(0.01, 10.0, allow_nan=False), min_size=n, max_size=n),
        min_size=1, max_size=12))
    thr = data.draw(st.floats(1.1, 3.0))
    pat = data.draw(st.integers(1, 4))
    ours = StragglerMonitor(n, threshold=thr, patience=pat)
    ref = jfault.StragglerMonitor(n, threshold=thr, patience=pat)
    for times in steps:
        assert ours.observe(times) == ref.observe(times)
        assert ours.ewma == ref.ewma and ours.strikes == ref.strikes
    beats = data.draw(st.lists(st.tuples(st.integers(0, n - 1),
                                         st.floats(0, 100)), max_size=20))
    hb, jhb = HeartbeatTracker(n, 15.0), jfault.HeartbeatTracker(n, 15.0)
    for w, t in beats:
        hb.beat(w, now=t)
        jhb.beat(w, now=t)
    now = data.draw(st.floats(0, 150))
    assert hb.dead(now=now) == jhb.dead(now=now)
    mw = data.draw(st.integers(1, 8))
    for alive in range(0, 9):
        assert RestartPolicy(mw).plan(alive, 8) == \
            jfault.RestartPolicy(mw).plan(alive, 8)


def test_reshard_and_replicate_place_every_leaf():
    tree = {"w": np.ones((2, 3), np.float32), "l": [torch.zeros(2), None]}
    out = replicate_tree(tree, torch.device("cpu"))
    assert isinstance(out["w"], torch.Tensor) and out["l"][1] is None
    kept = reshard_tree(tree, {"w": None, "l": [torch.device("cpu"), None]})
    assert kept["w"] is tree["w"] and isinstance(kept["l"][0], torch.Tensor)


# ------------------------------------------------- (c) schedule and shards

@pytest.fixture(scope="module")
def sched_pools():
    """(port pool, reference pool) per bucket count, 8 subgraphs."""
    from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
    from repro.pipeline import PoolConfig as JaxPoolConfig
    from repro.pipeline import build_pool as jax_build_pool
    g, jg = sbm_graph(**GRAPH), jax_sbm_graph(**GRAPH)
    out = {}
    for nb in (1, 2):
        kw = dict(n_subgraphs=8, roots=50, walk_length=3, n_buckets=nb,
                  block=32, seed=3)
        out[nb] = (build_pool(g, PoolConfig(**kw)),
                   jax_build_pool(jg, JaxPoolConfig(**kw)))
    return out


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("dp", [2, 4])
def test_epoch_schedule_matches_reference(sched_pools, dp, nb):
    from repro.pipeline.sharding import ShardedPoolSource as JaxSource
    pool, jpool = sched_pools[nb]
    assert len(pool.buckets) == nb
    cfg = MinibatchConfig(seed=3, device="cpu")
    ref = JaxSource(jpool, cfg, SimpleNamespace(shape={"data": dp}))
    ours = [ShardedPoolSource(pool, cfg, SimpleNamespace(
        rank=r, world_size=dp, device=torch.device("cpu")))
        for r in range(dp)]
    assert ours[0].shards == ref.shards == shard_pool_ids(pool, dp)
    assert ours[0].steps_per_epoch == ref.steps_per_epoch
    for epoch in range(3):
        jsched = ref.epoch_schedule(epoch)
        for r, src in enumerate(ours):
            assert src.epoch_schedule(epoch) == jsched
        buckets = [{pool.subgraphs[s].bucket_id for s in t} for t in jsched]
        assert all(len(b) == 1 for b in buckets)
    assert ours[1].state_dict()["order_rng"] == \
        ref.state_dict()["order_rng"]


def test_shard_pool_ids_errors_match_reference(sched_pools):
    from repro.pipeline.sharding import shard_pool_ids as jax_shard
    pool, jpool = sched_pools[2]
    for n in (3, 8, 16):
        try:
            want = jax_shard(jpool, n)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                shard_pool_ids(pool, n)
            assert str(got.value) == str(e)
        else:
            assert shard_pool_ids(pool, n) == want
    # a bucket that does not split: 6 subgraphs in buckets of 3 and 3
    odd = build_pool(sbm_graph(**GRAPH), PoolConfig(**ODD_POOL))
    assert np.bincount([x.bucket_id for x in odd.subgraphs]).tolist() == [3, 3]
    with pytest.raises(ValueError, match="bucket 0 holds 3 subgraphs"):
        shard_pool_ids(odd, 2)


def test_dp_pool_rebuilds_single_bucket_or_raises():
    """A prebuilt pool whose buckets do not split raises the reference's
    error naming the bucket; one built from the graph is rebuilt with a
    single bucket, as the reference does."""
    g = sbm_graph(**GRAPH)
    cfg = MinibatchConfig(device="cpu", dp=2, **ODD_POOL)
    pool = build_pool(g, PoolConfig(**ODD_POOL))
    with pytest.raises(ValueError, match="bucket 0 holds 3 subgraphs"):
        dp_pool(cfg, pool=pool)
    rebuilt = dp_pool(cfg, graph=g)
    assert len(rebuilt.buckets) == 1 and len(rebuilt) == 6
    assert shard_pool_ids(rebuilt, 2) == [[0, 2, 4], [1, 3, 5]]


def test_mesh_spec_and_group_plan():
    assert parse_mesh_spec("4") == 4 and parse_mesh_spec("data:2") == 2
    with pytest.raises(ValueError, match="'model'"):
        parse_mesh_spec("data:2,model:2")
    plan = plan_group(2, force_host_devices=2, device="cpu")
    assert plan.backend == "gloo" and plan.devices == ("cpu", "cpu")
    with pytest.raises(ValueError, match="degree 4 > 2 visible"):
        plan_group(4, force_host_devices=2, device="cpu")
    with pytest.raises(ValueError, match="degree 2 > 1 visible"):
        plan_group(2, device="cpu")


# ------------------------------------------ the reference on 2 host devices

_REF_SCRIPT = r"""
import json, sys
import jax, numpy as np
from repro.graphs.synthetic import sbm_graph
from repro.pipeline import MinibatchConfig, MinibatchTrainer, stacked_operands

out_path, graph_kw, common, runs = sys.argv[1], *map(json.loads, sys.argv[2:])
assert len(jax.devices()) == 2, jax.devices()
g = sbm_graph(**graph_kw)
out = {}


def host(x):
    # gather first: JAX 0.9 refuses x[i] on an array sharded over "data"
    return np.asarray(jax.device_get(x))


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", None))) for k in path]
        out["/".join([prefix, *keys])] = host(leaf)


pool = None
for name, extra in runs.items():
    tr = MinibatchTrainer(MinibatchConfig(dp=2, rsc=False, **common, **extra),
                          g, pool=pool)
    pool = tr.pool
    if name == "plain":
        put("init", tr.engine.params)
    h = tr.train(eval_every=1)["history"]
    out[name + "/loss"] = np.asarray(h["loss"])
    out[name + "/sub_id"] = np.asarray(h["sub_id"])
    out[name + "/compress"] = np.asarray(h["compress"])
    put(name + "/final", tr.engine.params)
out["n_buckets"] = np.asarray(len(pool.buckets))

# two RSC steps of the DP runner on the first step's subgraphs: the cold
# (exact) plans, then the plans refreshed from the first step's norms
tr = MinibatchTrainer(MinibatchConfig(dp=2, rsc=True, **common), g, pool=pool)
eng = tr.engine
sids = eng.source.epoch_schedule(0)[0]
ops = stacked_operands(pool, [pool.subgraphs[i] for i in sids],
                       eng.runner.mesh)
params, opt_state = eng.params, eng.opt_state
out["rsc/sids"] = np.asarray(sids)
for step in range(2):
    plans = eng.planner.plans_for(sids, step, eng.schedule)
    for op, p in plans.items():
        for f in ("sel", "row_ids", "col_ids", "row_ptr", "n_active"):
            out[f"rsc{step}/plans/{op}/{f}"] = host(getattr(p, f))
        out[f"rsc{step}/plans/{op}/s_pad"] = np.asarray(p.s_pad)
    params, opt_state, lv, norms = eng.runner.rsc_step(
        params, opt_state, ops, plans, jax.random.PRNGKey(step), False)
    out[f"rsc{step}/loss"] = host(lv)
    put(f"rsc{step}/params", params)
    norms = {k: host(v) for k, v in norms.items()}
    for k, v in norms.items():
        out[f"rsc{step}/norms/{k}"] = v
    for i, sid in enumerate(sids):
        eng.planner.pools[i].record_norms(
            int(sid), {k: v[i] for k, v in norms.items()})
np.savez(out_path, **out)
"""


def _tree(flat: dict, prefix: str) -> dict:
    """The nested GCN params tree of the npz keys under ``prefix`` (the
    last layer's ``bn`` entry, ``None``, has no leaf)."""
    items = {}
    for k, v in flat.items():
        if k.startswith(prefix + "/"):
            path = tuple(int(p) if p.isdigit() else p
                         for p in k[len(prefix) + 1:].split("/"))
            items[path] = v
    tree = convert._nest(items)
    tree["bn"] += [None] * (COMMON["n_layers"] - len(tree["bn"]))
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(out), json.dumps(GRAPH),
         json.dumps(COMMON), json.dumps(RUNS)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


# ------------------------------------------------------ the port's 2 ranks

def _rank_leaves(rank: int) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(100 + rank)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in sorted(LEAF_SHAPES.items())}


def _plan_arrays(p) -> dict:
    return {"sel": p.sel.numpy().copy(), "row_ids": p.row_ids.numpy().copy(),
            "col_ids": p.col_ids.numpy().copy(),
            "row_ptr": p.row_ptr.numpy().copy(), "n_active": int(p.n_active),
            "s_pad": int(p.s_pad)}


def _capture(planner) -> tuple[list, list]:
    plans, norms = [], []
    plans_for, record = planner.plans_for, planner.record

    def wrapped_plans(tag, step, schedule):
        out = plans_for(tag, step, schedule)
        plans.append({k: _plan_arrays(p) for k, p in out.items()})
        return out

    def wrapped_record(tag, nm):
        norms.append({k: v.numpy().copy() for k, v in nm.items()})
        record(tag, nm)

    planner.plans_for, planner.record = wrapped_plans, wrapped_record
    return plans, norms


def _params(model) -> dict:
    """The reference's params tree of ``model``, copied (on the CPU
    ``gnn_params_to_numpy`` gives views of the live parameters)."""
    def copy(t):
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        if isinstance(t, list):
            return [copy(v) for v in t]
        return None if t is None else np.array(t)
    return copy(convert.gnn_params_to_numpy(model))


def _history(res) -> dict:
    h = res["history"]
    return {k: list(h[k]) for k in ("loss", "sub_id", "mode", "compress")}


def port_rank(group, ref_path: str, ckpt_dir: str) -> dict:
    """Everything the port runs for (d)-(g) and the resume, on one rank."""
    from repro_torch.core.plan import SamplePlan
    from repro_torch.train.steps import bucketed_all_reduce
    ref = dict(np.load(ref_path))
    init = _tree(ref, "init")
    g = sbm_graph(**GRAPH)
    r = group.rank
    out = {"rank": r, "buckets": {}}
    for nb in range(1, 6):                                          # (d)
        red = bucketed_all_reduce(_rank_leaves(r), group, nb)
        out["buckets"][nb] = {k: v.numpy() for k, v in red.items()}
    out["per_leaf"] = {k: group.mean_(v).numpy()
                       for k, v in _rank_leaves(r).items()}

    def trainer(cfg_kw, pool, model=True, **extra):
        cfg = MinibatchConfig(dp=2, device="cpu", **cfg_kw, **extra)
        return MinibatchTrainer(
            cfg, g, pool, group=group,
            model=(convert.gnn_params_from_numpy("gcn", init, device="cpu")
                   if model else None))

    pool = None
    for name, extra in {**RUNS, "plain_overlap": {
            "overlap_allreduce": True, "overlap_buckets": 3}}.items():  # (e)
        tr = trainer(COMMON, pool, rsc=False, **extra)
        pool = tr.pool
        res = tr.train(eval_every=1)
        out[name] = {**_history(res),
                     "final": _params(tr.params)}
    out["n_buckets"] = len(pool.buckets)

    tr = trainer(COMMON, pool, rsc=True)                             # (f)
    eng = tr.engine
    sids = [int(s) for s in ref["rsc/sids"]]
    ops = device_operands(pool, pool.subgraphs[sids[r]], "cpu")
    gen = torch.Generator()
    for step in range(2):
        pre = f"rsc{step}/plans/"
        plans = {op: SamplePlan(
            sel=torch.from_numpy(ref[f"{pre}{op}/sel"][r].copy()),
            row_ids=torch.from_numpy(ref[f"{pre}{op}/row_ids"][r].copy()),
            col_ids=torch.from_numpy(ref[f"{pre}{op}/col_ids"][r].copy()),
            n_active=int(ref[f"{pre}{op}/n_active"][r]),
            s_pad=int(ref[f"{pre}{op}/s_pad"]),
            row_ptr=torch.from_numpy(ref[f"{pre}{op}/row_ptr"][r].copy()))
            for op in MODELS["gcn"].spmm_names(COMMON["n_layers"])}
        eng.model, eng.opt_state, lv, norms = eng.rsc_step(
            eng.model, eng.opt_state, ops, plans, gen, False)
        out[f"rsc{step}"] = {
            "loss": float(lv), "params": _params(eng.model), "norms": {k: v.numpy() for k, v in norms.items()}}

    tr = trainer(dict(COMMON, epochs=5), pool, rsc=True,             # (g)
                 compress_grads=True)
    plans, norms = _capture(tr.engine.planner)
    res = tr.train(eval_every=5)
    out["rsc_run"] = {**_history(res), "plans": plans, "norms": norms,
                      "hit_rate": res["plan_hit_rate"],
                      "flops_fraction": res["flops_fraction"],
                      "stats": [vars(s) for s in res["cache_stats"]]}

    kw = dict(COMMON, epochs=3, dropout=0.5, ckpt_dir=ckpt_dir,      # resume
              ckpt_every=5)
    a = trainer(kw, pool, model=False, rsc=True, compress_grads=True)
    ra = a.train(eval_every=1)
    group.barrier()
    b = trainer(kw, pool, model=False, rsc=True, compress_grads=True)
    step = b.engine.restore(step=5)
    rb = b.train(eval_every=1)
    out["resume"] = {"step": step, "a": _history(ra), "b": _history(rb),
                     "a_final": _params(a.params),
                     "b_final": _params(b.params),
                     "best": (ra["best_test"], rb["best_test"]),
                     "ckpt_dir": ckpt_dir}
    return out


def restore_rank(group, ckpt_dir: str) -> str:
    """A rank of a group of another size than the checkpoint's (or a
    trainer without a group, ``group`` None): its restore raises; returns
    the message."""
    dp = {"dp": group.world_size, "compress_grads": True} if group else {}
    tr = MinibatchTrainer(MinibatchConfig(
        device="cpu", rsc=True, **dp, **dict(COMMON, ckpt_dir=ckpt_dir)),
        sbm_graph(**GRAPH), group=group)
    with pytest.raises(ValueError) as err:
        tr.engine.restore(step=5)
    return str(err.value)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_port")
    ref_path = tmp / "ref.npz"
    np.savez(ref_path, **reference)
    ranks = launch(port_rank, (str(ref_path), str(tmp / "ckpt")),
                   plan=plan_group(2, force_host_devices=2, device="cpu"),
                   threads=1)
    assert [o["rank"] for o in ranks] == [0, 1]
    return ranks


def _max_diff(a: dict, b: dict) -> float:
    def leaves(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from leaves(v, path + (i,))
        elif t is not None:
            yield path, np.asarray(t)
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    return max(float(np.max(np.abs(la[k] - lb[k]))) for k in la)


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5])
def test_bucketed_all_reduce_matches_reference(port, nb):
    """(d) 2 gloo ranks against ``_bucketed_pmean`` under ``vmap``."""
    import jax
    import jax.numpy as jnp
    from repro.train.steps import _bucketed_pmean
    stacked = {k: jnp.stack([jnp.asarray(_rank_leaves(r)[k].numpy())
                             for r in (0, 1)]) for k in LEAF_SHAPES}
    ref = jax.vmap(lambda t: _bucketed_pmean(t, "data", nb),
                   axis_name="data")(stacked)
    per_leaf = jax.vmap(lambda t: jax.tree.map(
        lambda x: jax.lax.pmean(x, "data"), t), axis_name="data")(stacked)
    for o in port:
        for k in LEAF_SHAPES:
            assert np.array_equal(o["buckets"][nb][k],
                                  np.asarray(ref[k][o["rank"]])), k
            assert np.array_equal(o["per_leaf"][k],
                                  np.asarray(per_leaf[k][o["rank"]])), k


@pytest.mark.parametrize("run", list(RUNS))
def test_exact_dp_trajectory_matches_reference(reference, port, run):
    """(e) the reference's DP engine on 2 host devices, exact mode."""
    assert int(reference["n_buckets"]) == port[0]["n_buckets"] == 2
    for o in port:
        h = o[run]
        assert [tuple(t) for t in reference[run + "/sub_id"].tolist()] == \
            h["sub_id"] and len(h["sub_id"]) == 8
        assert reference[run + "/compress"].tolist() == h["compress"]
        assert any(h["compress"]) == (run != "plain")
        np.testing.assert_allclose(h["loss"], reference[run + "/loss"],
                                   rtol=TRAJ_RTOL)
        assert _max_diff(h["final"], _tree(reference, run + "/final")) \
            <= 1e-5
    assert _max_diff(port[0][run]["final"], port[1][run]["final"]) == 0.0


def test_overlapped_allreduce_equals_per_leaf_bit_for_bit(port):
    """(e) in the port: bucketed all-reduce issued from the gradient hooks
    gives the per-leaf trajectory exactly, compressed or not."""
    for o in port:
        for a, b in (("compress", "overlap"), ("plain", "plain_overlap")):
            assert o[a]["loss"] == o[b]["loss"]
            assert _max_diff(o[a]["final"], o[b]["final"]) == 0.0


def test_rsc_dp_step_matches_reference(reference, port):
    """(f) the port's DP RSC step on the reference's plans."""
    for step in range(2):
        ref_norms = {k[len(f"rsc{step}/norms/"):]: v
                     for k, v in reference.items()
                     if k.startswith(f"rsc{step}/norms/")}
        for o in port:
            got = o[f"rsc{step}"]
            assert abs(got["loss"] - float(reference[f"rsc{step}/loss"])) \
                <= 1e-5
            assert _max_diff(got["params"],
                             _tree(reference, f"rsc{step}/params")) <= 1e-5
            assert got["norms"].keys() == ref_norms.keys()
            for k, v in ref_norms.items():
                np.testing.assert_allclose(got["norms"][k], v[o["rank"]],
                                           rtol=0, atol=1e-5)
    # the second step's plans were refreshed from the first step's norms
    n_active = [reference[k] for k in reference
                if k.startswith("rsc1/plans/") and k.endswith("/n_active")]
    full = [reference[k] for k in reference
            if k.startswith("rsc0/plans/") and k.endswith("/n_active")]
    assert sum(int(x.sum()) for x in n_active) < sum(int(x.sum())
                                                     for x in full)


def test_rsc_dp_plans_match_reference_plan_pools(port):
    """(g) each rank's plans at every RSC step equal the reference
    ``PlanCachePool`` (``shard{d}``) fed that rank's norms."""
    from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
    from repro.pipeline import MinibatchConfig as JaxMinibatchConfig
    from repro.pipeline import PlanCachePool as JaxPlanCachePool
    from repro.pipeline.minibatch_loop import _build_default_pool
    cfg = JaxMinibatchConfig(**dict(COMMON, epochs=5))
    jpool = _build_default_pool(cfg, jax_sbm_graph(**GRAPH), n_buckets=2)
    module = MODELS["gcn"]
    names = module.spmm_names(2)
    dims = module.spmm_dims(2, 24, jpool.num_classes)
    n_sampled = 0
    for o in port:
        run, d = o["rsc_run"], o["rank"]
        assert run["compress"] == [m == "rsc" for m in run["mode"]]
        assert "exact" in run["mode"] and run["compress"][0]
        ref = JaxPlanCachePool(jpool, names, dims, budget_frac=0.3,
                               step_frac=0.02, strategy="greedy",
                               refresh_every=2, label=f"shard{d}")
        rsc_tags = [t for t, m in zip(run["sub_id"], run["mode"])
                    if m == "rsc"]
        assert len(rsc_tags) == len(run["plans"]) == len(run["norms"])
        for tag, plans, norms in zip(rsc_tags, run["plans"], run["norms"]):
            jp = ref.plans_for(jpool.subgraphs[tag[d]])
            assert plans.keys() == jp.keys()
            for k, p in jp.items():
                for f in ("sel", "row_ids", "col_ids", "row_ptr"):
                    assert np.array_equal(plans[k][f],
                                          np.asarray(getattr(p, f))), (k, f)
                assert plans[k]["n_active"] == int(p.n_active)
                assert plans[k]["s_pad"] == p.s_pad
                n_sampled += plans[k]["n_active"] < len(
                    jpool.subgraphs[tag[d]].meta.row_ids)
            ref.record_norms(tag[d], norms)
        assert run["stats"][d] == vars(ref.stats)
        assert 0 < run["hit_rate"] and run["flops_fraction"] <= 0.3
    assert n_sampled > 0
    assert port[0]["rsc_run"]["loss"] == port[1]["rsc_run"]["loss"]


def test_dp_resume_is_step_exact(port):
    """Stopped after step 5 and restored on both ranks (dropout 0.5, RSC,
    compression): the uninterrupted run's losses and parameters bit for
    bit."""
    for o in port:
        res = o["resume"]
        assert res["step"] == 5
        assert res["b"]["loss"] == res["a"]["loss"][5:]
        assert res["b"]["sub_id"] == res["a"]["sub_id"][5:]
        assert res["b"]["compress"] == res["a"]["compress"][5:]
        assert _max_diff(res["a_final"], res["b_final"]) == 0.0
        assert res["best"][0] == res["best"][1]


@pytest.mark.parametrize("world", [1, 4])
def test_dp_restore_at_another_world_size_names_both(port, world):
    """The ``--dp 2`` checkpoint of the resume run, restored by 1 rank (a
    trainer without a group) or by 4 gloo ranks: a ``ValueError`` naming
    both counts, before any rank indexes the saved shards."""
    ckpt_dir = port[0]["resume"]["ckpt_dir"]
    if world == 1:
        msgs = [restore_rank(None, ckpt_dir)]
    else:
        msgs = launch(restore_rank, (ckpt_dir,),
                      plan=plan_group(world, force_host_devices=world,
                                      device="cpu"), threads=1)
    assert len(msgs) == world
    for m in msgs:
        assert f"2 data-parallel shard(s), this run has {world} rank(s)" \
            in m, m


# ------------------------------------------------------------------- (h) CLI

def test_cli_dp_prints_reference_keys(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("RSC_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    out = train_cli.main(CLI_ARGV + ["--dp", "2", "--force-host-devices",
                                     "2", "--compress-grads",
                                     "--overlap-allreduce", "--device",
                                     "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {
        "model", "dataset", "rsc", "budget", "best_test", "wall_s",
        "flops_fraction", "minibatch", "pool", "subgraphs", "n_buckets",
        "plan_hit_rate", "dp", "compress_grads", "overlap_allreduce",
        "shards"}
    assert report["dp"] == 2 and report["compress_grads"] is True
    assert [s["label"] for s in report["shards"]] == ["shard0", "shard1"]
    assert 0 <= report["flops_fraction"] <= 0.1
    ranks = out["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    steps = len(ranks[0]["result"]["history"]["loss"])
    assert steps == 4 * 4 // 2
    assert all(r["launches"]["bcoo_spmm"] == 0 for r in ranks)   # CPU
    assert ranks[0]["allreduce"]["overlap"] and \
        len(ranks[1]["allreduce"]["reduce_ms"]) == steps
    assert ranks[1]["report"] is None


def test_cli_dp_without_host_devices_names_the_count():
    with pytest.raises(ValueError, match="degree 2 > 1 visible"):
        train_cli.main(CLI_ARGV + ["--dp", "2", "--device", "cpu"])
