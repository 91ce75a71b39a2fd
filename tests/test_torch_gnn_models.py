"""GraphSAGE (MEAN) and GCNII on the port against the reference.

On the 700-node SBM graph (block 32, hidden 48), with the reference's
parameters carried across by ``convert.gnn_params_from_numpy`` (biases and
batchnorm affines randomised so every leaf's conversion counts):

* the training ``apply`` against the reference's (backend ``jnp``);
* parameter and tap gradients of the loss, under the exact backward and
  under sampled plans, against ``jax.grad``;
* the streaming-inference logits (``NodeServer``) against the reference's
  ``StreamingInference`` / ``NodeServer``;
* a 30-step RSC trajectory from the reference engine's initial parameters
  (3 layers, batchnorm, dropout 0, budget 0.3) on backends ``kernel`` and
  ``ref``: identical plans at every step, losses, ∇H norms and final
  parameters within ``TRAJ_RTOL``, as ``test_torch_gnn_train.py`` holds
  GCN;
* the planner scoring (D⁻¹A)ᵀ with ‖D⁻¹A‖_F for GraphSAGE;
* the convert round trips and the reference's ``test_models_learn``.

Tolerances: logits and gradients at rtol 1e-4 and atol 1e-4·max|ref| per
tensor — both packages sum the same f32 products in other orders (as in
``test_torch_serve.py`` / ``test_torch_rsc_spmm.py``); trajectories at
``TRAJ_RTOL`` = 1e-5 (GCN's limit).

Inert biases: a bias that feeds batchnorm directly (GraphSAGE's ``self``
and ``neigh`` biases on hidden layers, GCNII's ``w[l]`` biases) shifts
every row alike, which batchnorm removes, so its gradient is zero up to
rounding (~1e-9 here) on both sides; such gradients are held to
``1e-5·max`` of the tree's gradients instead. Adam scales that noise up
to steps of about the learning rate, so after training these biases hold
rounding-driven values in both packages: the trajectory test leaves them
out of the final-parameter comparison and checks instead that they do
not change the logits.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import build_plan as jax_build_plan
from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
from repro.infer import NodeServer as JaxNodeServer
from repro.infer import StreamConfig as JaxStreamConfig
from repro.models.gnn import MODELS as JAX_MODELS
from repro.models.gnn.common import build_operands as jax_build_operands
from repro.train.loop import GNNTrainer as JaxGNNTrainer
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.steps import gnn_loss as jax_gnn_loss
from repro_torch import convert
from repro_torch.core.plan import build_plan
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.infer import NodeServer, StreamConfig
from repro_torch.models.gnn import MODELS, gcnii, graphsage
from repro_torch.models.gnn.common import build_operands
from repro_torch.train.loop import GNNTrainer, TrainConfig
from repro_torch.train.steps import gnn_loss

from tests.test_torch_gnn_train import _capture
from tests.test_torch_gnn_train import one_torch_thread  # noqa: F401

GRAPH = dict(n_nodes=700, n_clusters=7, avg_degree=12, feat_dim=32, seed=0)
NEW = ["graphsage", "gcnii"]
HIDDEN, CLASSES, BLOCK = 48, 7, 32
TRAJ_RTOL = 1e-5


@pytest.fixture(scope="module")
def graphs():
    return sbm_graph(**GRAPH), jax_sbm_graph(**GRAPH)


@pytest.fixture(scope="module")
def operands(graphs):
    g, r = graphs
    return (build_operands(g, BLOCK, BLOCK, device="cpu"),
            jax_build_operands(r, BLOCK, BLOCK))


def _tree(model, layers, batchnorm=True, seed=0):
    """The reference's parameters as numpy, biases and batchnorm affines
    randomised."""
    tree = jax.device_get(JAX_MODELS[model].init(
        jax.random.PRNGKey(seed), GRAPH["feat_dim"], HIDDEN, CLASSES, layers,
        batchnorm))
    rng = np.random.default_rng(seed)

    def jitter(node):
        if isinstance(node, dict) and isinstance(node.get("w"), np.ndarray):
            node["b"] = 0.1 * rng.standard_normal(node["b"].shape) \
                .astype(np.float32)
        elif isinstance(node, dict) and "g" in node:
            node["g"] = (1.0 + 0.2 * rng.standard_normal(node["g"].shape)
                         ).astype(np.float32)
            node["b"] = 0.1 * rng.standard_normal(node["b"].shape) \
                .astype(np.float32)
        elif isinstance(node, dict):
            for v in node.values():
                jitter(v)
        elif isinstance(node, list):
            for v in node:
                jitter(v)

    jitter(tree)
    return tree


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4,
                               atol=1e-4 * scale)


# ------------------------------ training apply ------------------------------

@pytest.mark.parametrize("model", NEW)
@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("batchnorm", [True, False])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_apply_matches_reference(operands, model, layers, batchnorm,
                                 backend):
    (ops, _), (jops, _) = operands
    tree = _tree(model, layers, batchnorm)
    net = convert.gnn_params_from_numpy(model, tree, "cpu")
    with torch.no_grad():
        ours = MODELS[model].apply(net, ops, {}, None, dropout_rate=0.0,
                                   train=True, backend=backend)
    ref = JAX_MODELS[model].apply(tree, jops, {}, None, dropout_rate=0.0,
                                  train=True, backend="jnp")
    assert ours.shape == (704, CLASSES)
    _close(ours.numpy()[:700], np.asarray(ref)[:700])


def _plans(model, layers, ops, meta, jops, jmeta, sampled: bool):
    """Per-op plans over the model's backward operand: every column block
    kept, or a seeded 50 % of them (bucket 16, so sentinel padding)."""
    if model == "graphsage":
        at, at_meta, jat, jat_meta = ops.amt, meta.amt_meta, jops.amt, \
            jmeta.amt_meta
    else:
        at, at_meta, jat, jat_meta = ops.at, meta.at_meta, jops.at, \
            jmeta.at_meta
    rng = np.random.default_rng(3)
    ours, ref = {}, {}
    for name in MODELS[model].spmm_names(layers):
        keep = rng.random(at.n_col_blocks) < 0.5 if sampled else None
        bucket = 16 if sampled else 1
        ours[name] = build_plan(at_meta, keep, at.n_row_blocks, at.s_total,
                                bucket, device="cpu")
        ref[name] = jax_build_plan(jat_meta, keep, jat.n_row_blocks,
                                   jat.s_total, bucket)
    return ours, ref


def _inert(model, tree) -> list[dict]:
    """The linears whose bias feeds batchnorm directly (see the module
    docstring)."""
    bn = [b is not None for b in tree["bn"]]
    if model == "gcnii":
        return [p for p, b in zip(tree["w"], bn) if b]
    return [p for group in ("self", "neigh")
            for p, b in zip(tree[group], bn) if b]


def _grad_tree(net, grads):
    """The gradients laid out as the reference's parameter tree."""
    g = copy.deepcopy(net)
    with torch.no_grad():
        for p, x in zip(g.parameters(), grads):
            p.copy_(x)
    return convert.gnn_params_to_numpy(g)


@pytest.mark.parametrize("model", NEW)
@pytest.mark.parametrize("plan", ["exact", "sampled"])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_gradients_match_jax_grad(operands, model, plan, backend):
    (ops, meta), (jops, jmeta) = operands
    layers = 3
    module, jmodule = MODELS[model], JAX_MODELS[model]
    tree = _tree(model, layers)
    net = convert.gnn_params_from_numpy(model, tree, "cpu")
    plans = jplans = None
    if plan == "sampled":
        plans, jplans = _plans(model, layers, ops, meta, jops, jmeta, True)
    shapes = module.tap_shapes(layers, 704, HIDDEN, CLASSES)
    assert shapes == jmodule.tap_shapes(layers, 704, HIDDEN, CLASSES)
    taps = {k: torch.zeros(s, requires_grad=True) for k, s in shapes.items()}
    loss = gnn_loss(module.apply(net, ops, taps, plans, dropout_rate=0.0,
                                 train=True, backend=backend), ops)
    params = list(net.parameters())
    out = torch.autograd.grad(loss, [*params, *taps.values()])

    def jloss(p, t):
        return jax_gnn_loss(jmodule.apply(p, jops, t, jplans,
                                          dropout_rate=0.0, train=True,
                                          backend="jnp"), jops)

    jtaps = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    jval, (gp, gt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jtaps)
    assert abs(float(loss) - float(jval)) <= 1e-6 * abs(float(jval))
    ours, gp = _grad_tree(net, out[:len(params)]), jax.device_get(gp)
    assert jax.tree.structure(ours) == jax.tree.structure(gp)
    top = max(float(np.abs(x).max()) for x in jax.tree.leaves(gp))
    inert = list(zip(_inert(model, ours), _inert(model, gp)))
    assert len(inert) == (2 * (layers - 1) if model == "graphsage"
                          else layers)
    for a, b in inert:
        assert np.abs(a["b"]).max() <= 1e-5 * top
        assert np.abs(b["b"]).max() <= 1e-5 * top
        a["b"] = b["b"] = np.zeros_like(b["b"])
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(gp)):
        _close(a, b)
    for k, g in zip(taps, out[len(params):]):
        _close(g.numpy()[:700], np.asarray(gt[k])[:700])
        assert float(g.abs().max()) > 0, k


def test_graphsage_layer0_has_no_backward_spmm(operands):
    """Layer 0's SpMM acts on the features: no tap, no plan, and its
    backward never runs (``needs_input_grad``), so a step makes L forward
    SpMMs and L-1 backward ones."""
    (ops, _), _ = operands
    net = graphsage.init(32, HIDDEN, CLASSES, 3, True, device="cpu")
    assert graphsage.spmm_names(3) == ["sage/spmm1", "sage/spmm2"]
    calls = []
    from repro_torch.kernels import ops as kops
    inner = kops.bcoo_spmm_in_range

    def counting(*a, **k):
        calls.append(a[4].shape[1])
        return inner(*a, **k)

    kops.bcoo_spmm_in_range = counting
    try:
        loss = gnn_loss(graphsage.apply(net, ops, {}, None,
                                        dropout_rate=0.0), ops)
        loss.backward()
    finally:
        kops.bcoo_spmm_in_range = inner
    # forward at d = 32 (features), 48, 48; backward of layers 2 and 1
    assert calls == [32, HIDDEN, HIDDEN, HIDDEN, HIDDEN]


# ------------------------------ serving -------------------------------------

@pytest.mark.parametrize("model", NEW)
@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("batchnorm", [True, False])
@pytest.mark.parametrize("n_parts", [1, 3])
def test_node_server_matches_reference(graphs, model, layers, batchnorm,
                                       n_parts):
    g, r = graphs
    tree = _tree(model, layers, batchnorm, seed=1)
    cfg = dict(block=BLOCK, n_partitions=n_parts, memory_budget_mb=None)
    srv = NodeServer(g, model, convert.gnn_params_from_numpy(model, tree,
                                                             "cpu"),
                     StreamConfig(device="cpu", **cfg))
    jsrv = JaxNodeServer(r, model, tree, JaxStreamConfig(**cfg))
    assert srv.si.n_partitions == jsrv.si.n_partitions == n_parts
    assert np.isfinite(srv.si.logits).all()
    _close(srv.si.logits[:700], jsrv.si.logits[:700])
    ids = np.random.default_rng(0).integers(0, g.n, 64)
    ours = srv.query(ids)
    _close(ours, jsrv.query(ids))
    np.testing.assert_array_equal(ours, srv.si.logits[srv.si.pos[ids]])
    for l in range(layers):
        ref_st = jsrv.si.bn_stats[l]
        if ref_st is None:
            assert srv.si.bn_stats[l] is None
        else:
            for a, b in zip(srv.si.bn_stats[l], ref_st):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_serving_equals_training_eval_forward(graphs, operands):
    """The streaming forward (host row ops) and the training evaluation
    forward (device row ops) give the same logits for both models."""
    g, _ = graphs
    (ops, _), _ = operands
    for model in NEW:
        net = convert.gnn_params_from_numpy(model, _tree(model, 3, seed=2),
                                            "cpu")
        srv = NodeServer(g, model, net, StreamConfig(block=BLOCK,
                                                     device="cpu"))
        with torch.no_grad():
            ev = MODELS[model].apply(net, ops, {}, None, dropout_rate=0.0,
                                     train=False).numpy()
        _close(srv.si.logits[:700], ev[:700])


def test_infer_hooks(graphs):
    sage = graphsage.init(32, 16, 5, 3, True, seed=4, device="cpu")
    assert graphsage.infer_spmm_dims(sage, 32) == [32, 16, 16]
    assert graphsage.infer_pre(sage, 0) is None
    deep = gcnii.init(32, 16, 5, 4, True, seed=4, device="cpu")
    assert gcnii.infer_spmm_dims(deep, 32) == [16] * 4
    assert gcnii.infer_n_layers(deep) == 4 and len(deep.bn) == 4
    feats = np.random.default_rng(0).standard_normal((8, 32)) \
        .astype(np.float32)
    h0, ctx = gcnii.infer_init(deep, feats)
    assert h0 is ctx and h0.shape == (8, 16) and (h0 >= 0).all()
    ref = np.maximum(feats @ deep.proj_in.weight.detach().numpy().T
                     + deep.proj_in.bias.detach().numpy(), 0)
    np.testing.assert_allclose(h0, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", NEW)
def test_seeded_init_is_deterministic_and_local(model):
    module = MODELS[model]
    torch.manual_seed(123)
    state = torch.random.get_rng_state()
    a, b, c = (module.init(16, 32, 5, 3, True, seed=s, device="cpu")
               for s in (4, 4, 5))
    assert torch.equal(torch.random.get_rng_state(), state)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    assert any(not torch.equal(x, z) for x, z in zip(a.parameters(),
                                                      c.parameters()))
    first = a.self_lin[0] if model == "graphsage" else a.proj_in
    w = first.weight.detach().numpy()
    assert abs(w.std() - np.sqrt(2 / 16)) < 0.05
    assert not first.bias.detach().any()


# ------------------------------ trajectory ----------------------------------

def _traj(model):
    return dict(model=model, n_layers=3, hidden=HIDDEN, block=BLOCK,
                batchnorm=True, dropout=0.0, rsc=True, budget=0.3,
                epochs=30)


@pytest.fixture(scope="module")
def reference_runs(graphs):
    """The reference engine's 30 steps for each model: initial params,
    result, plans, norms, final params."""
    _, r = graphs
    runs = {}
    for model in NEW:
        tr = JaxGNNTrainer(JaxTrainConfig(**_traj(model), backend="jnp"), r)
        init = jax.device_get(tr.engine.params)
        plans, norms = _capture(tr.engine.planner, np.asarray)
        res = tr.train(eval_every=10)
        runs[model] = (init, res, plans, norms,
                       jax.device_get(tr.engine.params))
    return runs


@pytest.mark.parametrize("model", NEW)
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_trajectory_matches_reference(graphs, reference_runs, model,
                                      backend):
    g, _ = graphs
    init, jres, jplans, jnorms, jfinal = reference_runs[model]
    tr = GNNTrainer(TrainConfig(**_traj(model), backend=backend,
                                device="cpu"),
                    g, model=convert.gnn_params_from_numpy(model, init,
                                                           "cpu"))
    plans, norms = _capture(tr.engine.planner, lambda t: t.numpy())
    res = tr.train(eval_every=10)

    assert res["history"]["mode"] == jres["history"]["mode"]
    assert res["history"]["mode"].count("rsc") == 24
    np.testing.assert_allclose(res["history"]["loss"],
                               jres["history"]["loss"], rtol=TRAJ_RTOL)
    assert len(plans) == len(jplans) == 24
    n_sampled = 0
    for ours, ref in zip(plans, jplans):
        assert ours.keys() == ref.keys() == set(
            MODELS[model].spmm_names(3))
        for k in ours:
            assert all(np.array_equal(a, b)
                       for a, b in zip(ours[k][0], ref[k][0])), k
            assert ours[k][1:] == ref[k][1:], k
            n_sampled += ours[k][1] < ours[k][2]
    assert n_sampled > 0                       # some plan really sampled
    assert res["cache_stats"].refreshes == jres["cache_stats"].refreshes == 2
    for ours, ref in zip(norms, jnorms):
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=0,
                                       atol=TRAJ_RTOL * ref[k].max())
    assert res["flops_fraction"] == jres["flops_fraction"] <= 0.3
    final = convert.gnn_params_to_numpy(tr.params)
    assert jax.tree.structure(final) == jax.tree.structure(jfinal)
    # the inert biases hold rounding-driven values on both sides; setting
    # ours to zero leaves the logits as they were
    ops = tr.engine.source.ops
    with torch.no_grad():
        before = tr.engine.eval_logits(tr.params, ops)
        for p in _inert(model, final) + _inert(model, jfinal):
            p["b"] = np.zeros_like(p["b"])
        zeroed = convert.gnn_params_from_numpy(model, final, "cpu")
        after = tr.engine.eval_logits(zeroed, ops)
    _close(after.numpy()[:700], before.numpy()[:700])
    for ours, ref in zip(jax.tree.leaves(final), jax.tree.leaves(jfinal)):
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=TRAJ_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("model,operand", [("graphsage", "amt"),
                                           ("gcnii", "at"), ("gcn", "at")])
def test_planner_scores_the_backward_operand(graphs, model, operand):
    """The planner registers every op on the operand of the model's
    backward SpMM, with its Frobenius norm: (D⁻¹A)ᵀ and ‖D⁻¹A‖_F for
    GraphSAGE, Ãᵀ and ‖Ã‖_F otherwise, as the reference's engine does."""
    g, r = graphs
    cfg = dict(model=model, n_layers=3, hidden=16, block=BLOCK, rsc=True,
               budget=0.3, epochs=1)
    src = GNNTrainer(TrainConfig(**cfg, device="cpu"), g).engine
    ref = JaxGNNTrainer(JaxTrainConfig(**cfg, backend="jnp"), r).engine
    ops_, meta = src.source.ops, src.source.meta
    at = getattr(ops_, operand)
    at_meta = meta.amt_meta if operand == "amt" else meta.at_meta
    fro = meta.am_fro if operand == "amt" else meta.a_fro
    assert meta.am_fro != meta.a_fro
    cache, jcache = src.planner.cache, ref.planner.cache
    assert list(cache.ops) == list(jcache.ops) \
        == MODELS[model].spmm_names(3)
    for name, e in cache.ops.items():
        je = jcache.ops[name]
        assert e.at is at and e.meta is at_meta and e.a_fro == fro
        assert e.a_fro == je.a_fro
        for f in ("row_ids", "col_ids", "col_block_norm", "col_norm"):
            assert np.array_equal(getattr(e.meta, f), getattr(je.meta, f))


# ------------------------------ convert -------------------------------------

@pytest.mark.parametrize("model", NEW)
@pytest.mark.parametrize("layers", [1, 2, 4])
@pytest.mark.parametrize("batchnorm", [True, False])
def test_params_round_trip(model, layers, batchnorm):
    tree = _tree(model, layers, batchnorm)
    net = convert.gnn_params_from_numpy(model, tree, "cpu")
    back = convert.gnn_params_to_numpy(net)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    n_bn = sum(b is not None for b in tree["bn"])
    assert len(net.bn) == n_bn
    assert n_bn == (0 if not batchnorm else
                    layers if model == "gcnii" else layers - 1)


def test_convert_transposes_exactly_once():
    tree = _tree("graphsage", 2)
    net = convert.gnn_params_from_numpy("graphsage", tree, "cpu")
    x = np.random.default_rng(0).standard_normal((5, HIDDEN)) \
        .astype(np.float32)
    for lin, p in ((net.self_lin[0], tree["self"][0]),
                   (net.neigh_lin[1], tree["neigh"][1])):
        ours = lin(torch.from_numpy(x[:, :lin.in_features])).detach()
        np.testing.assert_allclose(
            ours.numpy(), x[:, :lin.in_features] @ p["w"] + p["b"],
            rtol=1e-5, atol=1e-5)
        assert tuple(lin.weight.shape) == p["w"].shape[::-1]
    deep = convert.gnn_params_from_numpy("gcnii", _tree("gcnii", 2), "cpu")
    assert tuple(deep.proj_in.weight.shape) == (HIDDEN, 32)
    assert tuple(deep.proj_out.weight.shape) == (CLASSES, HIDDEN)


def test_convert_rejects_malformed_trees():
    bad = _tree("graphsage", 3)
    bad["bn"][1] = None                          # batchnorm on some layers
    with pytest.raises(ValueError, match="every hidden layer"):
        convert.gnn_params_from_numpy("graphsage", bad, "cpu")
    bad = _tree("graphsage", 3)
    bad["neigh"] = bad["neigh"][:2]
    with pytest.raises(ValueError, match="neigh"):
        convert.gnn_params_from_numpy("graphsage", bad, "cpu")
    bad = _tree("graphsage", 2)
    bad["bn"][-1] = bad["bn"][0]                 # GCNII's layout
    with pytest.raises(ValueError, match="None on the last"):
        convert.gnn_params_from_numpy("graphsage", bad, "cpu")
    bad = _tree("gcnii", 3)
    bad["bn"] = bad["bn"][:2]                    # GCN's layout
    with pytest.raises(ValueError, match="one bn entry per layer"):
        convert.gnn_params_from_numpy("gcnii", bad, "cpu")
    bad = _tree("gcnii", 2)
    bad["w"][1]["w"] = bad["w"][1]["w"][:5]
    with pytest.raises(ValueError, match="does not chain"):
        convert.gnn_params_from_numpy("gcnii", bad, "cpu")
    with pytest.raises(ValueError, match="unknown model"):
        convert.gnn_params_from_numpy("gat", bad, "cpu")
    with pytest.raises(TypeError):
        convert.gnn_params_to_numpy(torch.nn.Linear(2, 2))


# --------------------- test_gnn_training.py behaviours ----------------------

@pytest.mark.parametrize("model,layers", [("graphsage", 2), ("gcnii", 3)])
def test_models_learn(graphs, model, layers):
    g, _ = graphs
    res = GNNTrainer(TrainConfig(model=model, n_layers=layers, hidden=48,
                                 epochs=50, block=BLOCK, dropout=0.2,
                                 device="cpu"), g).train(eval_every=10)
    assert res["best_test"] > 0.5  # chance = 1/7


@pytest.mark.parametrize("model", NEW)
def test_rsc_within_budget_and_close_to_baseline(graphs, model):
    g, _ = graphs
    base = dict(model=model, n_layers=3, hidden=48, epochs=50, block=BLOCK,
                dropout=0.2, device="cpu")
    exact = GNNTrainer(TrainConfig(**base), g).train(eval_every=10)
    rsc = GNNTrainer(TrainConfig(**base, rsc=True, budget=0.3),
                     g).train(eval_every=10)
    assert rsc["flops_fraction"] <= 0.3 + 1e-6
    assert rsc["best_test"] > exact["best_test"] - 0.07
