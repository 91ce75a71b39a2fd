"""The port's serving slice against the reference: streaming full-graph
forward and node queries from parameters carried across with
``convert.gnn_params_from_numpy``, and the ``serve_gnn`` entry point.

Tolerance: logits at atol 1e-4·max|logit| (rtol 0) — the two packages sum
the same f32 products of the pre-map and the SpMM in different orders.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
from repro.infer import NodeServer as JaxNodeServer
from repro.infer import StreamConfig as JaxStreamConfig
from repro.infer import StreamingInference as JaxStreamingInference
from repro.models.gnn import MODELS as JAX_MODELS
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.infer import NodeServer, StreamConfig, StreamingInference
from repro_torch.kernels import ops
from repro_torch.launch import serve_gnn
from repro_torch.graphs.datasets import load_dataset
from repro_torch.models.gnn import MODELS as MODELS_PORT
from repro_torch.models.gnn import gcn
from repro_torch.models.gnn.common import build_operands

from tests.test_torch_gnn_train import one_torch_thread  # noqa: F401

GRAPH = dict(n_nodes=500, n_clusters=5, avg_degree=10, feat_dim=16, seed=0)


@pytest.fixture(scope="module")
def graphs():
    return sbm_graph(**GRAPH), jax_sbm_graph(**GRAPH)


def _tree(layers, batchnorm, hidden=32, seed=0):
    """Reference GCN params as numpy, batchnorm affine params randomized
    so the conversion of every leaf is exercised."""
    params = JAX_MODELS["gcn"].init(jax.random.PRNGKey(seed), 16, hidden, 5,
                                    layers, batchnorm)
    tree = jax.device_get(params)
    rng = np.random.default_rng(seed)
    for p in tree["lin"]:
        p["b"] = rng.standard_normal(p["b"].shape).astype(np.float32) * 0.1
    for p in tree["bn"]:
        if p is not None:
            p["g"] = (1.0 + 0.2 * rng.standard_normal(p["g"].shape)
                      ).astype(np.float32)
            p["b"] = 0.1 * rng.standard_normal(p["b"].shape).astype(
                np.float32)
    return tree


def _close(ours, ref):
    atol = 1e-4 * float(np.abs(ref).max())
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("batchnorm", [True, False])
@pytest.mark.parametrize("parts", [dict(n_partitions=1, memory_budget_mb=None),
                                   dict(n_partitions=3, memory_budget_mb=None),
                                   dict(memory_budget_mb=0.25)])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_stream_forward_matches_reference(graphs, layers, batchnorm, parts,
                                          backend):
    g, r = graphs
    tree = _tree(layers, batchnorm)
    net = gnn_params_from_numpy("gcn", tree, "cpu")
    si = StreamingInference(g, "gcn", net, StreamConfig(
        block=32, backend=backend, device="cpu", **parts))
    jsi = JaxStreamingInference(r, "gcn", tree,
                                JaxStreamConfig(block=32, **parts))
    assert si.n_partitions == jsi.n_partitions
    if "memory_budget_mb" in parts and parts["memory_budget_mb"]:
        assert si.n_partitions >= 3
    ours, ref = si.forward(), jsi.forward()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    assert np.isfinite(ours).all()
    _close(ours[: g.n], ref[: g.n])


@pytest.mark.parametrize("batchnorm", [True, False])
@pytest.mark.parametrize("n_parts", [1, 3])
def test_node_server_queries_match_reference(graphs, batchnorm, n_parts):
    g, r = graphs
    tree = _tree(3, batchnorm, seed=1)
    cfg = dict(block=32, n_partitions=n_parts, memory_budget_mb=None)
    srv = NodeServer(g, "gcn", gnn_params_from_numpy("gcn", tree, "cpu"),
                     StreamConfig(device="cpu", **cfg))
    jsrv = JaxNodeServer(r, "gcn", tree, JaxStreamConfig(**cfg))
    ids = np.random.default_rng(0).integers(0, g.n, 64)
    ours = srv.query(ids)
    _close(ours, jsrv.query(ids))
    # each answer is the cached logits row of the node's operand position
    np.testing.assert_array_equal(ours, srv.si.logits[srv.si.pos[ids]])
    np.testing.assert_array_equal(srv.predict(ids), ours.argmax(-1))
    st = srv.stats()
    assert (st["version"], st["applied_seq"]) == (0, 0)
    assert st["queries"] == 128 and st["clock_anomalies"] == 0
    assert st["n_partitions"] == n_parts
    for l in (0, 1):     # frozen batchnorm statistics (mu, var)
        if batchnorm:
            for ours_s, ref_s in zip(srv.si.bn_stats[l], jsrv.si.bn_stats[l]):
                np.testing.assert_allclose(ours_s, ref_s, rtol=1e-4,
                                           atol=1e-5)
        else:
            assert srv.si.bn_stats[l] is None


def test_query_rejects_out_of_range_ids(graphs):
    g, _ = graphs
    srv = NodeServer(g, "gcn", gcn.init(16, 8, 5, 2, True, device="cpu"),
                     StreamConfig(block=32, device="cpu"))
    with pytest.raises(IndexError):
        srv.query([g.n])
    with pytest.raises(IndexError):
        srv.query([-1])
    assert srv.query([]).shape == (0, 5)


def test_convert_transposes_exactly_once():
    tree = _tree(3, True)
    net = gnn_params_from_numpy("gcn", tree, "cpu")
    x = np.random.default_rng(0).standard_normal((7, 16)).astype(np.float32)
    lin = net.lin[0]
    ours = torch.matmul(torch.from_numpy(x), lin.weight.t()) + lin.bias
    np.testing.assert_allclose(ours.detach().numpy(),
                               x @ tree["lin"][0]["w"] + tree["lin"][0]["b"],
                               rtol=1e-5, atol=1e-5)
    assert tuple(lin.weight.shape) == (32, 16)
    np.testing.assert_array_equal(net.batchnorm(1).weight.detach().numpy(),
                                  tree["bn"][1]["g"])
    assert net.batchnorm(2) is None
    with pytest.raises(ValueError):
        bad = _tree(2, True)
        bad["lin"][1]["w"] = bad["lin"][1]["w"][:5]
        gnn_params_from_numpy("gcn", bad, "cpu")


def test_seeded_init_is_deterministic_and_local():
    torch.manual_seed(123)
    state = torch.random.get_rng_state()
    a, b, c = (gcn.init(16, 32, 5, 3, True, seed=s, device="cpu")
               for s in (4, 4, 5))
    assert torch.equal(torch.random.get_rng_state(), state)
    for x, y, z in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(x, y)
    assert not torch.equal(a.lin[0].weight, c.lin[0].weight)
    w = a.lin[0].weight.detach().numpy()
    assert abs(w.std() - np.sqrt(2 / 16)) < 0.05
    assert gcn.infer_spmm_dims(a, 16) == [32, 32, 5]
    assert len(a.bn) == 2 and a.batchnorm(2) is None


def test_stream_rejects_params_on_another_device(graphs):
    g, _ = graphs
    net = gcn.init(16, 8, 5, 2, True, device="cpu").to("meta")
    with pytest.raises(ValueError, match="params are on"):
        StreamingInference(g, "gcn", net, StreamConfig(block=32,
                                                       device="cpu"))


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_serve_gnn_main_on_cpu(capsys):
    argv = ["--dataset", "reddit", "--scale", "0.002", "--layers", "3",
            "--hidden", "32", "--block", "32", "--memory-budget-mb", "0.5",
            "--queries", "40", "--query-batch", "16", "--device", "cpu",
            "--replicas", "0"]
    ops.reset_launch_counts()
    out = serve_gnn.main(argv)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed.startswith("{") and '"device": "cpu"' in printed
    assert out["device"] == "cpu" and out["replicas"] == 0
    assert out["query_batches"] == 3 and out["queries"] == 40
    assert out["n_partitions"] >= 2
    assert out["serve_stats"]["queries"] == 40
    assert out["serve_stats"]["clock_anomalies"] == 0
    assert ops.launch_counts()["bcoo_spmm"] == 0     # plain version on CPU
    res, srv = serve_gnn.run(serve_gnn.build_parser().parse_args(argv))
    assert np.isfinite(srv.si.logits).all()
    assert srv.si.logits.shape[1] == 41


SERVE_ARGV = ["--dataset", "reddit", "--scale", "0.002", "--layers", "3",
              "--hidden", "32", "--block", "32", "--queries", "40",
              "--query-batch", "16", "--device", "cpu", "--replicas", "0"]


@pytest.mark.parametrize("model", ["graphsage", "gcnii"])
def test_serve_gnn_other_models_on_cpu(capsys, model):
    """``--model graphsage|gcnii`` with ``--train-epochs 2``: the
    reference's progress line, then one JSON line; every query answered
    from the cached logits."""
    out = serve_gnn.main(SERVE_ARGV + ["--model", model, "--train-epochs",
                                       "2", "--memory-budget-mb", "0.5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[serve] trained 2 epochs, test=")
    assert lines[-1].startswith("{") and out["model"] == model
    assert out["queries"] == out["serve_stats"]["queries"] == 40
    assert out["n_partitions"] >= 2


def _eval_logits(graph, model, net, block):
    """The training path's full-graph evaluation forward (device row ops,
    fresh batchnorm statistics), in operand order."""
    module = MODELS_PORT[model]
    ops_, _ = build_operands(graph, block, block,
                             mean_agg=module.uses_mean_agg(), device="cpu")
    with torch.no_grad():
        return module.apply(net, ops_, {}, None, dropout_rate=0.0,
                            train=False).numpy()


@pytest.mark.parametrize("model", ["gcn", "graphsage", "gcnii"])
def test_serve_gnn_serves_the_trained_model(model):
    """``--train-epochs 2 --dropout 0``: the served logits are the trained
    model's full-graph evaluation forward (within 1e-4·max|logit|, the
    host and device row ops summing in other orders), and differ from the
    untrained model's."""
    argv = SERVE_ARGV + ["--model", model, "--dropout", "0"]
    args = serve_gnn.build_parser().parse_args(argv + ["--train-epochs",
                                                       "2"])
    _, srv = serve_gnn.run(args)
    g = load_dataset("reddit", scale=0.002, seed=0)
    n = g.n
    _close(srv.si.logits[:n], _eval_logits(g, model, srv.si.params, 32)[:n])
    _, fresh = serve_gnn.run(serve_gnn.build_parser().parse_args(
        argv + ["--train-epochs", "0"]))
    assert not np.allclose(fresh.si.logits[:n], srv.si.logits[:n])


@pytest.mark.parametrize("flag", [
    ["--replicas", "2"],
    ["--update-edges", "3"], ["--sampled-budget", "0.5"],
    ["--stream-resident-mb", "8"], ["--stream-overlap"],
    ["--slow-log", "s.json"]])
def test_serve_gnn_flags_on_cpu(tmp_path, capsys, flag):
    """Each serving flag of the reference runs on the CPU behind the
    default frontend (2 replicas) and gives the reference's result keys;
    the served answers are the first replica's cached logits."""
    if flag[0] == "--slow-log":
        flag = [flag[0], str(tmp_path / flag[1])]
    argv = ["--dataset", "reddit", "--scale", "0.002", "--layers", "2",
            "--hidden", "16", "--block", "32", "--train-epochs", "0",
            "--queries", "24", "--query-batch", "8", "--device", "cpu",
            *flag]
    out, fe = serve_gnn.run(serve_gnn.build_parser().parse_args(argv))
    assert {"dataset", "model", "n_nodes", "replicas", "n_partitions",
            "cache_build_s", "queries", "query_batches", "queries_per_s",
            "updates", "serve_stats"} <= set(out)
    assert out["replicas"] == 2 and out["query_batches"] == 3
    st = out["serve_stats"]
    assert st["replicas"] == 2 and st["log_seq"] == len(out["updates"])
    assert st["min_applied_seq"] == st["log_seq"]
    assert sum(s["queries"] for s in st["servers"]) == 24
    n_upd = int(flag[1]) if flag[0] == "--update-edges" else 0
    assert [u["seq"] for u in out["updates"]] == list(range(1, n_upd + 1))
    sampled = flag[0] == "--sampled-budget"
    assert (fe.sampled_server is not None) == sampled
    assert (st["sampled_rel_error"] is not None) == sampled
    r0, r1 = fe.replicas
    np.testing.assert_array_equal(r0.si.logits, r1.si.logits)
    assert all(s["version"] == n_upd for s in st["servers"])
    if flag[0] == "--stream-resident-mb":
        assert r0.si.lru is not None and r0.si.lru.misses > 0
    if flag[0] == "--slow-log":
        rec = json.loads(open(flag[1]).read())
        assert rec["kept"] == rec["offered"] == 3
        assert all("phases" in r for r in rec["slow"])
        assert "[serve] slow-request log" in capsys.readouterr().out
    assert not fe._dispatcher.is_alive() and not fe._updater.is_alive()
