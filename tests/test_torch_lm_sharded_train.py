"""LM training on a (data × model) mesh against the reference's
single-device step.

The reference's own sharded step (``tests/test_sharding_multidevice.py``)
cannot run on the installed JAX, and asserts only that it equals its
single-device step; the port's sharded step is held against that
single-device step here. Four gloo ranks on the CPU are spawned once
(``distributed.group.launch``) and run every case; each result is
asserted by its own test:

(a) dense parity: qwen3's and qwen2's f32 smoke configs (qwen2 has qkv
    biases and 2 kv heads) on meshes (data 2, model 2), (1, 2) and
    (2, 1), in 1 and 2 microbatches, with RSC (bk 32, keep 0.5) and
    without, and once with an active ``clip_norm``: 2 steps from the
    reference's initial parameters and batches. The blocks each RSC'd
    linear selects per microbatch equal the reference's, the losses are
    within 1e-5 relative, and each parameter's change is within 1e-3 of
    the reference's change in L2 norm, or within twice what the reference's
    own change moves when every weight moves one unit in the last place,
    where that is more (f32; the two sum the same products in other
    orders, and Adam turns a small gradient's rounding into a step of
    about lr: qwen2's k bias, whose gradient RoPE alone keeps from 0, moves
    that way);
(b) real sharding: every rank's parameter, m and v blocks have the shape
    its spec gives (the counterpart of ``test_params_actually_sharded``);
(c) every family's f32 smoke config on (data 2), one step in 2
    microbatches with RSC, against the reference's step: equal selected
    blocks, losses and changes within the limits of (a). The step is
    plain SGD (lr 1), so each change is the gradient itself: Adam's first
    step is ``±lr`` for every gradient above its eps, and a gradient that
    cancels to near 0 (there are some in the xLSTM, RG-LRU and MLA
    smoke models) flips with the order of a sum, in the port's
    single-device step too;
(d) elastic resharding: the (2, 2) state after 2 steps, gathered to
    whole arrays and placed on (2, 1) and (1, 1), gathers back bit for
    bit (parameters and moments); one more step on each new mesh tracks
    the reference's third step within the limits of (a);
(e) no fallback: a config with a dimension that tensor parallelism
    splits whole per rank and ``model`` does not divide raises, naming
    the dimension: query heads (dense and MLA), experts, the shared
    experts' width, the LRU width, mLSTM and sLSTM heads.

The non-dense families on the ``model`` axis are held against the
reference in ``test_torch_lm_sharded_families.py``.
"""
import dataclasses
import functools
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import make_batch, smoke_config
from repro_torch.distributed.elastic import gather_tree, reshard_tree
from repro_torch.distributed.group import launch, plan_group
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm.backbone import ShardedLM, init_params
from repro_torch.train.lm_steps import local_batch, make_sharded_train_step
from repro_torch.train.optimizer import Adam

DENSE = ["qwen3-1.7b", "qwen2-0.5b"]
FAMILIES = ["xlstm-125m", "recurrentgemma-9b", "llama-3.2-vision-11b",
            "deepseek-v2-lite-16b", "deepseek-v2-236b", "musicgen-medium"]
MESHES = [(2, 2), (1, 2), (2, 1)]
RSC = {"keep_frac": 0.5, "bk": 32}
B, T, LR, STEPS = 4, 64, 1e-3, 2
CLIP = 0.05          # below the smoke model's gradient norm: the clip acts
ELASTIC = ("qwen3-1.7b", (2, 2), 2, True, None)
# (arch, mesh, microbatches, rsc, clip): each arch's main case (2
# microbatches with RSC) on every mesh; the other combinations of
# microbatches and RSC spread over the two archs and meshes (each
# reference run costs a compilation)
RUNS = [(a, m, 2, True, None) for a in DENSE for m in MESHES] + [
    ("qwen3-1.7b", (2, 2), 1, False, None),
    ("qwen3-1.7b", (1, 2), 1, False, None),
    ("qwen2-0.5b", (2, 2), 1, True, None),
    ("qwen2-0.5b", (2, 1), 1, True, None),
    ("qwen2-0.5b", (2, 2), 2, False, None),
    ("qwen2-0.5b", (1, 2), 2, False, None),
    ("qwen3-1.7b", (2, 2), 2, True, CLIP)]
REL = 1e-3


def _cfg(arch):
    return dataclasses.replace(smoke_config(arch), dtype="float32")


# ------------------------------------------------------------ ranks
def _recording():
    """Record every global block selection of the sharded RSC dW."""
    mod = sys.modules["repro_torch.core.rsc_matmul"]
    log, inner = [], mod.top_blocks

    def top_blocks(scores, keep):
        idx = inner(scores, keep)
        log.append(idx.tolist())
        return idx
    mod.top_blocks = top_blocks
    return log


class SGD:
    """``p ← p − lr·g``: a step that is the gradient itself, for the
    families' check (Adam's first step is ``±lr`` wherever the gradient
    is above its eps, so a gradient near 0 turns rounding into a full
    step). ``update`` takes the arguments of either package's Adam."""

    lr = 1.0

    def init(self, params):
        return {"count": 0}

    def update(self, grads, state, params, shardings=None):
        return ({k: -self.lr * g.float() for k, g in grads.items()},
                {"count": state["count"] + 1})


def _train(mesh, arch, tree, n_mb, rsc, opt, steps, log):
    cfg = _cfg(arch)
    state = convert.lm_sharded_from_numpy(cfg, tree, mesh, "cpu")
    ost = opt.init(state.shards)
    step = make_sharded_train_step(cfg, opt, mesh, n_mb,
                                   RSC if rsc else None)
    log.clear()
    losses = []
    for i in range(steps):
        batch = make_batch(cfg, "train_4k", B, T, seed=i)
        state, ost, loss = step(state, ost, local_batch(batch, mesh, n_mb))
        losses.append(float(loss))
    return state, ost, losses, list(log)


def _shapes(state, ost) -> list:
    """(name, block shapes of the parameter, m and v, the spec's)."""
    return [(n, tuple(p.shape), tuple(ost["m"][n].shape),
             tuple(ost["v"][n].shape),
             state.shardings[n].local_shape(
                 tuple(dict(state.skeleton.named_parameters())[n].shape)))
            for n, p in state.shards.items()]


def _elastic(state, ost, cfg, meshes, log):
    """Gather the trained state, place it on each new mesh, check it
    gathers back bit for bit, take one more step there."""
    full = {k: gather_tree(t, state.shardings)
            for k, t in (("p", state.shards), ("m", ost["m"]),
                         ("v", ost["v"]))}
    out = {}
    for sizes, mesh in meshes:
        if not mesh.member:
            continue
        sh = convert.lm_param_shardings(cfg, mesh)
        moved = {k: reshard_tree(t, sh) for k, t in full.items()}
        back = {k: gather_tree(t, sh) for k, t in moved.items()}
        exact = all(torch.equal(back[k][n], full[k][n])
                    for k in full for n in full[k])
        st2 = ShardedLM(cfg, mesh, moved["p"], sh)
        opt = Adam(lr=LR)
        ost2 = {"m": moved["m"], "v": moved["v"], "count": ost["count"]}
        step = make_sharded_train_step(cfg, opt, mesh, 2, RSC)
        batch = make_batch(cfg, "train_4k", B, T, seed=STEPS)
        log.clear()
        st2, ost2, loss = step(st2, ost2, local_batch(batch, mesh, 2))
        out[sizes] = {"exact": exact, "loss": float(loss), "sel": list(log),
                      "params": convert.lm_sharded_to_numpy(st2)}
    return out


def rank_main(group, trees: dict, family_trees: dict) -> dict:
    torch.manual_seed(0)
    log = _recording()
    shapes = {m: Mesh(m, ("data", "model")) for m in MESHES + [(1, 1)]}
    meshes = {m: mesh.bind("cpu") for m, mesh in shapes.items()}
    data2 = Mesh((2,), ("data",)).bind("cpu")
    out = {"runs": {}, "shapes": {}, "families": {}, "elastic": {}}
    for run in RUNS:
        arch, m, n_mb, rsc, clip = run
        mesh = meshes[m]
        if not mesh.member:
            continue
        state, ost, losses, sel = _train(mesh, arch, trees[arch], n_mb, rsc,
                                         Adam(lr=LR, clip_norm=clip), STEPS,
                                         log)
        full = convert.lm_sharded_to_numpy(state)
        out["shapes"][run] = _shapes(state, ost)
        out["runs"][run] = {"losses": losses, "sel": sel, "params": full}
        if run == ELASTIC:
            out["elastic"] = _elastic(
                state, ost, _cfg(arch),
                [((2, 1), meshes[(2, 1)]), ((1, 1), meshes[(1, 1)])], log)
    for arch, tree in family_trees.items():
        if not data2.member:
            continue
        st, _, losses, sel = _train(data2, arch, tree, 2, True, SGD(), 1,
                                    log)
        out["families"][arch] = {"losses": losses, "sel": sel,
                                 "params": convert.lm_sharded_to_numpy(st)}
    return out


# ------------------------------------------------------------ reference
def _jax():
    import jax
    import repro.core.rsc_matmul  # noqa: F401
    from repro.configs import make_batch as jmb
    from repro.configs import smoke_config as jsc
    from repro.train import optimizer as jopt
    from repro.train.lm_steps import make_train_step
    return jax, sys.modules["repro.core.rsc_matmul"], jmb, jsc, jopt, \
        make_train_step


def _gated(tree):
    for blk in tree["blocks"]:
        if "ffn_gate" in blk:
            blk["ffn_gate"] = np.full_like(blk["ffn_gate"], 0.5)
            blk["attn"]["gate"] = np.full_like(blk["attn"]["gate"], -0.7)
    return tree


def _nudged(tree):
    """Every leaf one unit in the last place of f32 up or down."""
    import jax
    rng = np.random.default_rng(0)
    ulp = np.float32(2.0 ** -23)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) * (
        1 + ulp * rng.choice(np.array([-1, 1], np.float32), np.shape(a))),
        tree)


def _jax_sgd():
    import jax
    import jax.numpy as jnp

    class JaxSGD:
        lr = SGD.lr

        def init(self, params):
            return {"count": jnp.zeros((), jnp.int32)}

        def update(self, grads, state, params):
            return (jax.tree.map(lambda g: -self.lr * g.astype(jnp.float32),
                                 grads), {"count": state["count"] + 1})
    return JaxSGD()


def _reference_runs(trees, arch, n_mb, rsc, clip, steps, opt=None):
    """The reference's jitted single-device steps from each of ``trees``
    (one compilation): per-step losses, the selected blocks (recorded by
    a ``jax.debug.callback`` wrapped around its ``sampled_xt_g``) and the
    parameters after each step."""
    jax, jr, jmb, jsc, jopt, mts = _jax()
    cfg = dataclasses.replace(jsc(arch), dtype="float32")
    log, inner = [], jr.sampled_xt_g

    def recording(x, g, keep, bk, backend="jnp"):
        scores = jr._block_norms(x, bk) * jr._block_norms(g, bk)
        _, idx = jax.lax.top_k(scores, keep)
        jax.debug.callback(lambda i: log.append(sorted(np.asarray(i)
                                                       .tolist())),
                           idx, ordered=True)
        return inner(x, g, keep, bk, backend)
    jr.sampled_xt_g = recording
    out = []
    try:
        opt = opt or jopt.Adam(lr=LR, clip_norm=clip)
        step = jax.jit(mts(cfg, opt, n_mb, rsc=RSC if rsc else None))
        for p in trees:
            st = opt.init(p)
            losses, params = [], []
            for i in range(steps):
                p, st, loss = step(p, st, jmb(cfg, "train_4k", B, T, seed=i))
                losses.append(float(loss))
                params.append(jax.device_get(p))
            jax.effects_barrier()
            out.append({"losses": losses, "sel": list(log),
                        "params": params})
            log.clear()
    finally:
        jr.sampled_xt_g = inner
    return out


def _init_tree(arch, seed):
    """Seeded initial parameters in the reference's tree layout (numpy)."""
    cfg = _cfg(arch)
    return convert.lm_params_to_numpy(init_params(cfg, seed, "cpu"), cfg)


def _references(trees, family_trees) -> tuple[dict, dict]:
    ref = {}
    for arch, _, n_mb, rsc, clip in RUNS:
        key = (arch, n_mb, rsc, clip)
        if key not in ref:
            ref[key] = _reference_runs([trees[arch], _nudged(trees[arch])],
                                       arch, n_mb, rsc, clip, STEPS + 1)
    fam_ref = {a: _reference_runs([t, _nudged(t)], a, 2, True, None, 1,
                                  _jax_sgd())
               for a, t in family_trees.items()}
    return ref, fam_ref


@pytest.fixture(scope="module")
def result():
    trees = {a: _init_tree(a, 0) for a in DENSE}
    family_trees = {a: _gated(_init_tree(a, 2)) for a in FAMILIES}
    # the reference's steps (mostly compilation) run beside the ranks
    box: dict = {}

    def references():
        try:
            box["ref"] = _references(trees, family_trees)
        except BaseException as e:      # re-raised below
            box["error"] = e
    worker = threading.Thread(target=references)
    worker.start()
    try:
        ranks = launch(rank_main, (trees, family_trees),
                       plan=plan_group(4, force_host_devices=4, device="cpu"),
                       threads=1)
    finally:
        worker.join()
    if "error" in box:
        raise box["error"]
    ref, fam_ref = box["ref"]
    return {"trees": trees, "family_trees": family_trees, "ref": ref,
            "fam_ref": fam_ref, "ranks": ranks}


def _leaves(tree):
    import jax
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


def _changes_close(ours, ref, start, own=None):
    """Each parameter's change within REL (or twice the reference's own
    rounding move, ``own``: the nudged run's parameters) of the
    reference's change, in L2 norm."""
    o, r, p0 = _leaves(ours), _leaves(ref), _leaves(start)
    r2 = _leaves(own) if own is not None else r
    assert len(o) == len(r) == len(p0)
    for a, b, b2, s in zip(o, r, r2, p0):
        moved = b - s
        lim = max(REL, 2 * np.linalg.norm(b2 - s - moved)
                  / max(np.linalg.norm(moved), 1e-30))
        assert np.linalg.norm((a - s) - moved) <= \
            lim * np.linalg.norm(moved) + 1e-12


# ------------------------------------------------------------ (a) parity
@pytest.mark.parametrize("run", RUNS, ids=lambda r: str(r))
def test_dense_sharded_step_matches_reference(result, run):
    arch, mesh, n_mb, rsc, clip = run
    ref, nudged = result["ref"][(arch, n_mb, rsc, clip)]
    got = result["ranks"][0]["runs"][run]
    sels = [r["runs"][run]["sel"] for r in result["ranks"]
            if run in r["runs"]]
    assert all(s == sels[0] for s in sels)       # every rank picks alike
    want = 3 * 2 * n_mb * STEPS if rsc else 0    # 3 linears, 2 layers
    assert len(got["sel"]) == want
    assert got["sel"] == ref["sel"][:want]
    np.testing.assert_allclose(got["losses"], ref["losses"][:STEPS],
                               rtol=1e-5)
    _changes_close(got["params"], ref["params"][STEPS - 1],
                   result["trees"][arch], nudged["params"][STEPS - 1])


# ------------------------------------------------------------ (b) blocks
@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_share(result, mesh):
    run = ("qwen2-0.5b", mesh, 2, True, None)
    n = 0
    for r in result["ranks"]:
        for name, p, m, v, want in r["shapes"].get(run, []):
            assert p == m == v == want, name
            n += 1
    cfg = _cfg("qwen2-0.5b")
    assert n == mesh[0] * mesh[1] * len(convert.lm_param_shardings(
        cfg, Mesh(mesh, ("data", "model"))))
    if mesh == (2, 2):   # embed (model, data): a quarter on each rank
        emb = [s for r in result["ranks"] for s in r["shapes"][run]
               if s[0] == "embed"]
        assert {e[1] for e in emb} == {(cfg.vocab // 2, cfg.d_model // 2)}


# ------------------------------------------------------------ (c) families
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_trains_on_the_data_axis(result, arch):
    ref, nudged = result["fam_ref"][arch]
    got = result["ranks"][0]["families"][arch]
    assert result["ranks"][1]["families"][arch]["sel"] == got["sel"]
    assert got["sel"] == ref["sel"]
    own = abs(nudged["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=max(1e-5, 2 * own))
    _changes_close(got["params"], ref["params"][0],
                   result["family_trees"][arch], nudged["params"][0])


# ------------------------------------------------------------ (d) elastic
@pytest.mark.parametrize("target", [(2, 1), (1, 1)])
def test_elastic_reshard_is_exact_and_continues(result, target):
    arch = ELASTIC[0]
    got = result["ranks"][0]["elastic"][target]
    assert got["exact"]
    if target == (2, 1):
        assert result["ranks"][1]["elastic"][target]["exact"]
    ref, nudged = result["ref"][(arch, 2, True, None)]
    assert got["sel"] == ref["sel"][2 * 2 * 3 * STEPS:]
    np.testing.assert_allclose(got["loss"], ref["losses"][STEPS], rtol=1e-5)
    _changes_close(got["params"], ref["params"][STEPS],
                   result["trees"][arch], nudged["params"][STEPS])


# ------------------------------------------------------------ (e) raises
def _moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


@pytest.mark.parametrize("arch,change,model,match", [
    ("deepseek-v2-lite-16b", lambda c: _moe(c, n_routed=6), 4, "n_routed"),
    ("deepseek-v2-236b", lambda c: _moe(c, d_expert=30), 4, "d_expert"),
    ("recurrentgemma-9b", lambda c: dataclasses.replace(c, lru_width=66),
     4, "lru_width"),
    ("xlstm-125m", lambda c: dataclasses.replace(c, mlstm_heads=3), 2,
     "mlstm_heads"),
    ("xlstm-125m", lambda c: dataclasses.replace(c, slstm_heads=2), 4,
     "slstm_heads"),
    ("deepseek-v2-lite-16b", lambda c: dataclasses.replace(
        c, n_heads=6, n_kv=6), 4, r"n_heads \(MLA heads\)"),
], ids=["n_routed", "d_expert", "lru_width", "mlstm_heads", "slstm_heads",
        "mla_heads"])
def test_model_axis_not_dividing_a_dimension_raises(arch, change, model,
                                                    match):
    with pytest.raises(ValueError, match=match):
        make_sharded_train_step(change(_cfg(arch)), Adam(),
                                Mesh((1, model), ("data", "model")))


def test_heads_model_does_not_divide_raise():
    cfg = dataclasses.replace(_cfg("qwen3-1.7b"), n_heads=3, n_kv=1)
    with pytest.raises(ValueError, match="n_heads"):
        make_sharded_train_step(cfg, Adam(), Mesh((1, 2), ("data", "model")))
    full = functools.partial(dataclasses.replace, smoke_config("qwen2-0.5b"))
    with pytest.raises(ValueError, match="n_heads"):   # 14 heads on 4
        make_sharded_train_step(full(n_heads=14, n_kv=2), Adam(),
                                Mesh((1, 4), ("data", "model")))
