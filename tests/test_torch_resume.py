"""Checkpoints and step-exact resume on the port, and across the packages.

* The checkpointer's cases of ``tests/test_checkpoint_distributed.py``
  (round trip, bf16 bit patterns, keep-k and the manifest, crash safety,
  the manifest trusted over the listing) and the aux round trip of
  ``tests/test_engine_resume.py``, on ``repro_torch.checkpoint``.
* ``tests/test_engine_resume.py``'s resumes on the port: full batch,
  minibatch mid-epoch with dropout 0.5, and the no-op continue from the
  final checkpoint; the resumed losses and final parameters equal the
  uninterrupted run's bit for bit.
* Across the packages: a checkpoint ``repro``'s engine wrote at step 15
  (dropout 0) continues in ``repro_torch`` to step 30 with the
  reference's plans at every step and losses within ``TRAJ_RTOL`` of
  ``repro``'s uninterrupted run; the port's checkpoint restores the same
  parameters in ``repro``, which continues it the same way. Both
  packages' LM checkpoints have the same keys, shapes and dtypes.
* ``launch.train lm --ckpt-dir``: 4 steps, then resumed to 8, equal 8
  uninterrupted steps.

Everything runs on the CPU.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.graphs.synthetic import sbm_graph as jax_sbm_graph
from repro.train.loop import GNNTrainer as JaxGNNTrainer
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.launch import train as train_cli
from repro_torch.pipeline import MinibatchConfig, MinibatchTrainer
from repro_torch.train.loop import GNNTrainer, TrainConfig
from repro_torch.train.optimizer import Adam

GRAPH = dict(n_nodes=400, n_clusters=4, avg_degree=10, feat_dim=12, seed=0)
TRAJ_RTOL = 1e-5
CROSS = dict(model="gcn", n_layers=2, hidden=24, epochs=30, block=32,
             dropout=0.0, rsc=True, budget=0.3, refresh_every=10, seed=3,
             ckpt_every=15)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per module: at this size threads buy nothing
    and contend for the cores under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return sbm_graph(**GRAPH)


def _same_model(a, b):
    for (na, x), (nb, y) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(x, y), na


# ------------------------------------------------------------ checkpointer

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)),
        "blocks": [{"a": torch.from_numpy(rng.standard_normal(4)).to(
                        torch.bfloat16)},
                   {"a": torch.from_numpy(rng.standard_normal(4)).to(
                        torch.bfloat16)}],
        "count": np.int32(7),
        "m": rng.standard_normal(5),
        "skip": None,
    }


def _zeros_like(t):
    if isinstance(t, torch.Tensor):
        return torch.zeros_like(t)
    if isinstance(t, np.ndarray):
        return np.zeros_like(t)
    return type(t)(0)


@pytest.mark.parametrize("leaf", ["w", "bf16", "count", "m"])
def test_checkpoint_roundtrip(tmp_path, leaf):
    """Each kind of leaf comes back with its value, kind and dtype; a bf16
    leaf's bits survive its uint16 view."""
    ck = Checkpointer(tmp_path, keep=2)
    t = _tree()
    ck.save(3, t, blocking=True)
    tmpl = {k: ([{"a": _zeros_like(b["a"])} for b in v] if k == "blocks"
                else (None if v is None else _zeros_like(v)))
            for k, v in t.items()}
    step, got = ck.restore(tmpl)
    assert step == 3 and got["skip"] is None
    if leaf == "bf16":
        for a, b in zip(t["blocks"], got["blocks"]):
            assert b["a"].dtype == torch.bfloat16
            assert torch.equal(a["a"].view(torch.int16),
                               b["a"].view(torch.int16))
    elif leaf == "count":
        assert got["count"] == 7 and isinstance(got["count"], np.int32)
    elif leaf == "w":
        assert torch.equal(got["w"], t["w"])
    else:
        np.testing.assert_array_equal(got["m"], t["m"])


def test_checkpoint_keep_k_and_manifest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), blocking=True)
    assert sorted(ck.all_steps()) == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_crash_safety(tmp_path):
    """A stale .tmp file (a crash mid-save) must not break restore."""
    ck = Checkpointer(tmp_path, keep=3)
    ck.save(1, _tree(1), blocking=True)
    (tmp_path / "step_2.npz.tmp").write_bytes(b"garbage-partial-write")
    assert ck.latest_step() == 1
    step, _ = ck.restore({"w": torch.zeros(8, 16)})
    assert step == 1


def test_checkpoint_manifest_trusted_over_listing(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    ck.save(5, _tree(), blocking=True)
    (tmp_path / "step_9.npz").write_bytes(b"\x00" * 10)     # torn write
    (tmp_path / "MANIFEST.json").write_text(json.dumps({"latest_step": 5}))
    assert ck.latest_step() == 5


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """The training step updates tensors in place: a save copies them
    before the writer thread starts, so a later in-place update never
    reaches the file."""
    ck = Checkpointer(tmp_path)
    w = torch.ones(256, 256)
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    _, got = ck.restore({"w": torch.zeros(256, 256)})
    assert torch.equal(got["w"], torch.ones(256, 256))


def test_checkpoint_aux_roundtrip_and_backward_compat(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    tree = {"w": np.arange(6, dtype=np.float32)}
    aux = {"gstep": 3, "key": np.asarray([1, 2], np.uint32),
           "norms": {"op": np.ones(4, np.float32)}, "nested": {"a": None}}
    ck.save(1, tree, blocking=True)             # no aux
    assert ck.load_aux(1) is None
    ck.save(2, tree, blocking=True, aux=aux)
    got = ck.load_aux(2)
    assert got["gstep"] == 3
    np.testing.assert_array_equal(got["key"], aux["key"])
    np.testing.assert_array_equal(got["norms"]["op"], aux["norms"]["op"])
    step, t2 = ck.restore(tree, step=2)         # aux never leaks in
    assert step == 2 and set(t2) == {"w"}
    np.testing.assert_array_equal(t2["w"], tree["w"])


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoint_layout_shared_with_reference(tmp_path, writer):
    """Each package reads the other's file: keys, f32/int32/bf16 leaves
    and aux."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(ml_dtypes.bfloat16)
    aux = {"gstep": 2, "norms": {"x": np.arange(3.0)}}
    if writer == "repro":
        JaxCheckpointer(tmp_path).save(
            7, {"p": [w, None], "q": {"b": b, "n": np.int32(4)}},
            blocking=True, aux=aux)
        step, got = Checkpointer(tmp_path).restore(
            {"p": [torch.zeros(3, 4), None],
             "q": {"b": torch.zeros(5, dtype=torch.bfloat16),
                   "n": np.int32(0)}})
        assert torch.equal(got["p"][0], torch.from_numpy(w))
        assert torch.equal(got["q"]["b"].view(torch.int16),
                           torch.from_numpy(b.view(np.int16)))
        assert got["q"]["n"] == 4
        got_aux = Checkpointer(tmp_path).load_aux()
    else:
        Checkpointer(tmp_path).save(
            7, {"p": [torch.from_numpy(w), None],
                "q": {"b": torch.from_numpy(b.view(np.int16)).view(
                    torch.bfloat16), "n": np.int32(4)}},
            blocking=True, aux=aux)
        jck = JaxCheckpointer(tmp_path)
        step, got = jck.restore({"p": [np.zeros((3, 4), np.float32), None],
                                 "q": {"b": np.zeros(5, ml_dtypes.bfloat16),
                                       "n": np.int32(0)}})
        np.testing.assert_array_equal(np.asarray(got["p"][0]), w)
        assert np.asarray(got["q"]["b"]).view(np.int16).tolist() == \
            b.view(np.int16).tolist()
        assert int(got["q"]["n"]) == 4
        got_aux = jck.load_aux()
    assert step == 7 and got_aux["gstep"] == 2
    np.testing.assert_array_equal(got_aux["norms"]["x"], np.arange(3.0))


# ------------------------------------------------- step-exact resume: port

def test_fullbatch_resume_is_step_exact(graph, tmp_path):
    common = dict(model="gcn", n_layers=2, hidden=24, epochs=12, block=32,
                  dropout=0.5, rsc=True, budget=0.3, refresh_every=3,
                  seed=1, ckpt_dir=str(tmp_path), ckpt_every=5,
                  device="cpu")
    A = GNNTrainer(TrainConfig(**common), graph)
    resA = A.train(eval_every=4)

    B = GNNTrainer(TrainConfig(**common), graph)
    step = B.engine.restore(step=10)
    assert step == 10
    resB = B.train(eval_every=4)
    assert resB["history"]["loss"] == resA["history"]["loss"][step:]
    assert resB["history"]["mode"] == resA["history"]["mode"][step:]
    _same_model(A.params, B.params)


def test_minibatch_resume_is_step_exact(graph, tmp_path):
    """Restore mid-epoch (RSC and dropout on) and continue: the resumed
    losses and final parameters equal the uninterrupted run's exactly
    (same plans, same pool order, same dropout draws)."""
    common = dict(model="gcn", n_layers=2, hidden=24, epochs=6, block=32,
                  dropout=0.5, rsc=True, budget=0.3, refresh_every=2,
                  seed=2, method="random_walk", n_subgraphs=4, roots=50,
                  walk_length=3, n_buckets=2, prefetch=False,
                  autotune=False, ckpt_dir=str(tmp_path), ckpt_every=9,
                  device="cpu")
    A = MinibatchTrainer(MinibatchConfig(**common), graph)
    resA = A.train(eval_every=3)
    lossesA = resA["history"]["loss"]
    assert len(lossesA) == 24                   # 6 epochs × 4 subgraphs

    B = MinibatchTrainer(MinibatchConfig(**common), graph)
    step = B.engine.restore(step=9)             # mid-epoch (9 % 4 != 0)
    assert step == 9
    resB = B.train(eval_every=3)
    assert resB["history"]["loss"] == lossesA[step:]
    assert resB["history"]["sub_id"] == resA["history"]["sub_id"][step:]
    _same_model(A.params, B.params)


def test_resume_from_final_checkpoint_is_noop_continue(graph, tmp_path):
    """The end-of-run snapshot resumes past the last step: a re-train with
    the same epoch budget runs no further step and keeps the params."""
    common = dict(model="gcn", n_layers=2, hidden=16, epochs=3, block=32,
                  dropout=0.0, rsc=False, seed=0, method="ldg",
                  n_subgraphs=2, n_buckets=1, prefetch=False,
                  autotune=False, ckpt_dir=str(tmp_path), ckpt_every=0,
                  device="cpu")
    A = MinibatchTrainer(MinibatchConfig(**common), graph)
    A.train(eval_every=3)

    B = MinibatchTrainer(MinibatchConfig(**common), graph)
    step = B.engine.restore()
    assert step == 6
    res = B.train(eval_every=3)
    assert res["history"]["loss"] == []
    _same_model(A.params, B.params)


def test_aux_holds_no_tensor_and_generator_state(graph, tmp_path):
    """The port's aux unpickles without torch types (numpy and Python
    only), carries the dropout generator's state and the reference's key
    as seeded."""
    cfg = TrainConfig(model="gcn", n_layers=2, hidden=16, epochs=2,
                      block=32, rsc=True, seed=4, ckpt_dir=str(tmp_path),
                      device="cpu")
    GNNTrainer(cfg, graph).train(eval_every=2)
    aux = Checkpointer(tmp_path).load_aux()

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)
        else:
            yield x
    assert not any(isinstance(v, torch.Tensor) for v in leaves(aux))
    assert aux["torch_generator"].dtype == np.uint8
    np.testing.assert_array_equal(aux["key"],
                                  np.asarray(jax.random.PRNGKey(5)))


# ----------------------------------------------------- across the packages

def _plans_of(planner, to_np):
    """Record each step's plans (as numpy)."""
    plans = []
    plans_for = planner.plans_for

    def wrapped(tag, step, schedule):
        out = plans_for(tag, step, schedule)
        plans.append({k: (tuple(to_np(getattr(p, f)) for f in
                                ("sel", "row_ids", "col_ids")),
                          int(p.n_active), p.s_pad)
                      for k, p in out.items()})
        return out

    planner.plans_for = wrapped
    return plans


def _same_plans(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert all(np.array_equal(p, q) for p, q in zip(x[k][0], y[k][0]))
            assert x[k][1:] == y[k][1:]


@pytest.fixture(scope="module")
def reference_30(tmp_path_factory):
    """``repro``'s uninterrupted 30 steps with a checkpoint at step 15."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    tr = JaxGNNTrainer(JaxTrainConfig(**CROSS, backend="jnp",
                                      ckpt_dir=str(d)),
                       jax_sbm_graph(**GRAPH))
    plans = _plans_of(tr.engine.planner, np.asarray)
    res = tr.train(eval_every=10)
    return d, res, plans, jax.device_get(tr.engine.params)


def test_reference_checkpoint_resumes_in_port(graph, reference_30):
    d, jres, jplans, jfinal = reference_30
    tr = GNNTrainer(TrainConfig(**CROSS, ckpt_dir=str(d), device="cpu"),
                    graph)
    assert tr.engine.restore(step=15) == 15
    tr.engine.ckpt = None                     # leave repro's files as they are
    plans = _plans_of(tr.engine.planner, lambda t: t.numpy())
    res = tr.train(eval_every=10)
    assert res["history"]["mode"] == jres["history"]["mode"][15:]
    _same_plans(plans, jplans[15:])
    np.testing.assert_allclose(res["history"]["loss"],
                               jres["history"]["loss"][15:], rtol=TRAJ_RTOL)
    final = convert.gnn_params_to_numpy(tr.params)
    for ours, ref in zip(jax.tree.leaves(final), jax.tree.leaves(jfinal)):
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=TRAJ_RTOL * np.abs(ref).max())


def test_port_checkpoint_resumes_in_reference(graph, tmp_path):
    """``repro`` restores the port's step-15 checkpoint to the port's own
    parameters and plans, and continues it (its key as seeded; dropout 0)
    to losses within TRAJ_RTOL of the port's uninterrupted run."""
    tr = GNNTrainer(TrainConfig(**CROSS, ckpt_dir=str(tmp_path),
                                device="cpu"), graph)
    plans = _plans_of(tr.engine.planner, lambda t: t.numpy())
    res = tr.train(eval_every=10)

    mid = GNNTrainer(TrainConfig(**CROSS, ckpt_dir=str(tmp_path),
                                 device="cpu"), graph)
    mid.engine.restore(step=15)
    jtr = JaxGNNTrainer(JaxTrainConfig(**CROSS, backend="jnp",
                                       ckpt_dir=str(tmp_path)),
                        jax_sbm_graph(**GRAPH))
    assert jtr.engine.restore(step=15) == 15
    want = convert.gnn_params_to_numpy(mid.params)
    got = jax.device_get(jtr.engine.params)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert np.array_equal(a, np.asarray(b))
    jtr.engine.ckpt = None
    jplans = _plans_of(jtr.engine.planner, np.asarray)
    jres = jtr.train(eval_every=10)
    _same_plans(jplans, plans[15:])
    np.testing.assert_allclose(jres["history"]["loss"],
                               res["history"]["loss"][15:], rtol=TRAJ_RTOL)


def test_lm_checkpoint_keys_match_reference(tmp_path):
    """The port's LM training state has the reference's tree paths,
    shapes and dtypes (smoke qwen3-1.7b; bf16 leaves included)."""
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models.lm.backbone import init_params as jax_init_params
    from repro.train.optimizer import Adam as JaxAdam
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm.backbone import init_params

    cfg = smoke_config("qwen3-1.7b")
    net = init_params(cfg, 0, "cpu")
    Checkpointer(tmp_path / "port").save(
        1, convert.lm_state_tree(net, Adam().init(
            dict(net.named_parameters())), cfg), blocking=True)
    jp = jax_init_params(jax.random.PRNGKey(0), jax_smoke_config("qwen3-1.7b"))
    JaxCheckpointer(tmp_path / "ref").save(1, (jp, JaxAdam().init(jp)),
                                           blocking=True)
    with np.load(tmp_path / "port" / "step_1.npz") as a, \
            np.load(tmp_path / "ref" / "step_1.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_train_lm_resume_equals_uninterrupted(tmp_path, capsys):
    base = ["lm", "--arch", "qwen3-1.7b", "--smoke", "--batch", "2",
            "--seq", "16", "--lr", "1e-3", "--device", "cpu"]
    straight = train_cli.main(base + ["--steps", "8"])
    d = str(tmp_path / "ck")
    first = train_cli.main(base + ["--steps", "4", "--ckpt-dir", d,
                                   "--ckpt-every", "2"])
    assert sorted(Checkpointer(d).all_steps()) == [2, 4]      # keep 2
    resumed = train_cli.main(base + ["--steps", "8", "--ckpt-dir", d,
                                     "--ckpt-every", "2"])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert resumed["start"] == 4 and resumed["report"]["steps"] == 4
    assert first["losses"] + resumed["losses"] == straight["losses"]
    _same_model(straight["params"], resumed["params"])
