"""Full-batch GNN training with RSC on the port against the reference.

* ``build_operands`` gives the reference's tiles, ids, masks and Frobenius
  norms bit for bit; ``gnn_loss`` agrees within 1e-6 relative (f32).
* A 30-step trajectory (GCN, 2 layers, hidden 48, block 32, batchnorm,
  dropout 0, RSC budget 0.3) from the reference engine's own initial
  parameters: the step modes are equal, every op's plan is identical at
  every step, and losses, ∇H row norms and the final parameters agree
  within ``TRAJ_RTOL`` — both sides run f32 with sums in other orders (on
  this machine the worst is ~5e-7; the limit leaves 20×).
* The ``tests/test_gnn_training.py`` behaviours, on the port: the model
  learns, RSC stays within 0.07 of the baseline, the budget controls the
  FLOPs, the switch-back tail is exact, ``caching=False`` refreshes every
  step, the uniform strategy runs, consecutive top-k selections overlap.
* The CLI (``repro_torch.launch.train gnn``).

Everything runs on the CPU (the kernel wrapper's plain version).
"""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
from repro.models.gnn.common import build_operands as jax_build_operands
from repro.train.loop import GNNTrainer as JaxGNNTrainer
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.steps import gnn_loss as jax_gnn_loss
from repro_torch import convert
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models.gnn.common import build_operands
from repro_torch.train.loop import GNNTrainer, TrainConfig
from repro_torch.train.steps import gnn_loss

GRAPH = dict(n_nodes=700, n_clusters=7, avg_degree=12, feat_dim=32, seed=0)
TRAJ = dict(model="gcn", n_layers=2, hidden=48, block=32, batchnorm=True,
            dropout=0.0, rsc=True, budget=0.3, epochs=30)
TRAJ_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run each module of these small-graph tests on one intra-op thread:
    at this size the threads buy nothing, and under the suite's parallel
    workers they contend for the cores (a module ran ~18× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return sbm_graph(**GRAPH)


# ------------------------------ operands -----------------------------------

def _same_bcoo(ours, ref):
    for f in ("blocks", "row_ids", "col_ids", "row_ptr"):
        assert np.array_equal(getattr(ours, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    for f in ("bm", "bk", "n_rows", "n_cols", "n_row_blocks",
              "n_col_blocks", "s_total"):
        assert getattr(ours, f) == getattr(ref, f), f


def _same_meta(ours, ref):
    for f in ("row_ids", "col_ids", "col_block_tiles", "col_block_norm",
              "col_nnz", "col_norm"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("degree_sort", [True, False])
def test_build_operands_matches_reference(graph, degree_sort):
    ops_, meta = build_operands(graph, 32, 32, degree_sort, device="cpu")
    jops, jmeta = jax_build_operands(jax_sbm_graph(**GRAPH), 32, 32,
                                     degree_sort)
    for f in ("a", "at", "am", "amt"):
        _same_bcoo(getattr(ops_, f), getattr(jops, f))
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        a, b = getattr(ops_, f).numpy(), np.asarray(getattr(jops, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ops_.n_valid == jops.n_valid == 700
    assert ops_.features.shape[0] == 704          # padded to the block
    assert (ops_.num_classes, ops_.multilabel) == (jops.num_classes,
                                                   jops.multilabel)
    _same_meta(meta.at_meta, jmeta.at_meta)
    _same_meta(meta.amt_meta, jmeta.amt_meta)
    assert meta.a_fro == jmeta.a_fro and meta.am_fro == jmeta.am_fro


def test_build_operands_skips_mean_pair(graph):
    full, fmeta = build_operands(graph, 32, 32, device="cpu")
    ops_, meta = build_operands(graph, 32, 32, mean_agg=False, device="cpu")
    assert ops_.am is None and ops_.amt is None and meta.amt_meta is None
    for f in ("a", "at"):
        for g in ("blocks", "row_ids", "col_ids", "row_ptr"):
            assert torch.equal(getattr(getattr(ops_, f), g),
                               getattr(getattr(full, f), g))
    assert meta.a_fro == fmeta.a_fro


@pytest.mark.parametrize("multilabel", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_gnn_loss_matches_reference(multilabel, weighted):
    rng = np.random.default_rng(0)
    n, c, n_valid = 96, 5, 90
    logits = rng.standard_normal((n, c)).astype(np.float32)
    labels = ((rng.random((n, c)) < 0.3).astype(np.float32) if multilabel
              else rng.integers(0, c, n).astype(np.int32))
    train = rng.random(n) < 0.6
    w = rng.random(n).astype(np.float32) + 0.5 if weighted else None

    def ns(arr):
        return SimpleNamespace(n_valid=n_valid, multilabel=multilabel,
                               train_mask=arr(train), labels=arr(labels),
                               loss_w=None if w is None else arr(w))

    ours = float(gnn_loss(torch.from_numpy(logits), ns(torch.from_numpy)))
    ref = float(jax_gnn_loss(jnp.asarray(logits), ns(jnp.asarray)))
    assert abs(ours - ref) <= 1e-6 * abs(ref)


# ----------------------------- trajectory ----------------------------------

def _capture(planner, to_np):
    """Record each step's plans (as numpy) and each RSC step's ∇H norms."""
    plans, norms = [], []
    plans_for, record = planner.plans_for, planner.record

    def wrapped_plans_for(tag, step, schedule):
        out = plans_for(tag, step, schedule)
        plans.append({k: (tuple(to_np(getattr(p, f)) for f in
                                ("sel", "row_ids", "col_ids", "row_ptr")),
                          int(p.n_active), p.s_pad)
                      for k, p in out.items()})
        return out

    def wrapped_record(tag, n):
        norms.append({k: to_np(v) for k, v in n.items()})
        record(tag, n)

    planner.plans_for, planner.record = wrapped_plans_for, wrapped_record
    return plans, norms


@pytest.fixture(scope="module")
def reference_run():
    """The reference engine's 30 steps, its initial and final params."""
    tr = JaxGNNTrainer(JaxTrainConfig(**TRAJ, backend="jnp"),
                       jax_sbm_graph(**GRAPH))
    init = jax.device_get(tr.engine.params)
    plans, norms = _capture(tr.engine.planner, np.asarray)
    res = tr.train(eval_every=10)
    return init, res, plans, norms, jax.device_get(tr.engine.params)


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_trajectory_matches_reference(graph, reference_run, backend):
    init, jres, jplans, jnorms, jfinal = reference_run
    tr = GNNTrainer(TrainConfig(**TRAJ, backend=backend, device="cpu"),
                    graph, model=convert.gnn_params_from_numpy(
                        "gcn", init, device="cpu"))
    plans, norms = _capture(tr.engine.planner, lambda t: t.numpy())
    res = tr.train(eval_every=10)

    assert res["history"]["mode"] == jres["history"]["mode"]
    assert res["history"]["mode"].count("rsc") == 24
    np.testing.assert_allclose(res["history"]["loss"],
                               jres["history"]["loss"], rtol=TRAJ_RTOL)
    # identical plans at every step, so at every refresh
    assert len(plans) == len(jplans) == 24
    for ours, ref in zip(plans, jplans):
        assert ours.keys() == ref.keys()
        for k in ours:
            assert all(np.array_equal(a, b)
                       for a, b in zip(ours[k][0], ref[k][0])), k
            assert ours[k][1:] == ref[k][1:], k
    # steps 10 and 20 (step 0 has no norms yet)
    assert res["cache_stats"].refreshes == jres["cache_stats"].refreshes == 2
    for ours, ref in zip(norms, jnorms):
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=0,
                                       atol=TRAJ_RTOL * ref[k].max())
    assert res["flops_fraction"] == jres["flops_fraction"] <= 0.3
    final = convert.gnn_params_to_numpy(tr.params)
    for ours, ref in zip(jax.tree.leaves(final), jax.tree.leaves(jfinal)):
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=TRAJ_RTOL * np.abs(ref).max())


def test_params_round_trip(reference_run):
    init = reference_run[0]
    back = convert.gnn_params_to_numpy(
        convert.gnn_params_from_numpy("gcn", init, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(init)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(init)):
        assert np.array_equal(a, np.asarray(b))


def test_training_steps_skip_the_host_index_check(graph, monkeypatch):
    """Every SpMM of a training step (forward, sampled and exact backward,
    evaluation) goes through the in-range entry: the checked entry, which
    reads index extrema back from the device, is never called."""
    def refuse(*a, **k):
        raise AssertionError("checked bcoo_spmm on the training path")

    monkeypatch.setattr(ops, "bcoo_spmm", refuse)
    res = GNNTrainer(TrainConfig(**{**TRAJ, "epochs": 5, "rsc_fraction": 0.6},
                                 device="cpu"), graph).train(eval_every=2)
    assert res["history"]["mode"] == ["rsc"] * 3 + ["exact"] * 2


# --------------------- test_gnn_training.py behaviours ---------------------

def _run(graph, **kw):
    base = dict(model="gcn", n_layers=2, hidden=48, epochs=50, block=32,
                dropout=0.2, device="cpu")
    base.update(kw)
    return GNNTrainer(TrainConfig(**base), graph).train(eval_every=10)


def test_model_learns(graph):
    assert _run(graph)["best_test"] > 0.5  # chance = 1/7


def test_rsc_close_to_baseline(graph):
    base = _run(graph)
    rsc = _run(graph, rsc=True, budget=0.3)
    assert rsc["best_test"] > base["best_test"] - 0.07
    assert rsc["flops_fraction"] <= 0.3 + 1e-6


def test_budget_controls_flops(graph):
    f = []
    for c in (0.1, 0.5):
        res = _run(graph, rsc=True, budget=c, epochs=25)
        assert res["flops_fraction"] <= c + 1e-6
        f.append(res["flops_fraction"])
    assert f[0] < f[1]


def test_switchback_runs_exact_tail(graph):
    res = _run(graph, rsc=True, budget=0.3, epochs=30)
    modes = res["history"]["mode"]
    assert modes[-1] == "exact" and modes[0] == "rsc"
    assert abs(modes.count("exact") - 0.2 * len(modes)) <= 2


def test_no_caching_refreshes_every_step(graph):
    res = _run(graph, rsc=True, budget=0.3, epochs=20, caching=False)
    n_rsc = res["history"]["mode"].count("rsc")
    assert res["cache_stats"].refreshes == n_rsc - 1


def test_uniform_strategy_runs(graph):
    res = _run(graph, rsc=True, budget=0.3, epochs=20, strategy="uniform")
    assert res["best_test"] > 0.4


def test_topk_index_stability_auc(graph):
    """Fig. 4: consecutive-refresh top-k selections overlap strongly."""
    aucs = _run(graph, rsc=True, budget=0.3, epochs=40)["cache_stats"] \
        .auc_history
    assert len(aucs) > 0 and np.mean(aucs) > 0.8


# --------------------------------- CLI -------------------------------------

SKILL_ARGV = ["gnn", "--dataset", "reddit", "--scale", "0.003", "--rsc",
              "--epochs", "20", "--block", "32", "--hidden", "48",
              "--layers", "2"]


def test_cli_prints_reference_keys(capsys):
    train_cli.main(SKILL_ARGV + ["--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"model", "dataset", "rsc", "budget", "best_test",
                           "wall_s", "flops_fraction"}
    assert report["rsc"] is True and report["model"] == "gcn"
    assert 0 < report["flops_fraction"] <= 0.1
    assert report["best_test"] > 1 / 41


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(SKILL_ARGV)


@pytest.mark.parametrize("flag,model", [
    (["--model", "graphsage", "--layers", "3"], "graphsage"),
    (["--model", "gcnii", "--layers", "3"], "gcnii"),
    (["--backend", "dense"], "gcn"), (["--backend", "ref"], "gcn")])
def test_cli_flags_run_on_cpu(capsys, flag, model):
    """``--model graphsage|gcnii`` and ``--backend dense|ref`` train on
    the CPU and print the reference's keys."""
    train_cli.main(SKILL_ARGV + ["--device", "cpu", *flag])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"model", "dataset", "rsc", "budget", "best_test",
                           "wall_s", "flops_fraction"}
    assert report["model"] == model and report["rsc"] is True
    assert 0 < report["flops_fraction"] <= 0.1
    assert report["best_test"] > 1 / 41


@pytest.mark.parametrize("flag,item", [
    (["--minibatch", "--dp", "2"], "item 8"), (["--dp", "4"], "item 8"),
    (["--mesh", "data:4"], "item 8"), (["--compress-grads"], "item 8"),
    (["--minibatch", "--mesh", "data:2"], "item 8")])
def test_cli_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        train_cli.main(SKILL_ARGV + ["--device", "cpu", *flag])
