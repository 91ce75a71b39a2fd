"""Tensor parallelism over ``model`` for the six non-dense LM families,
against the reference's single-device step.

xlstm-125m (mLSTM + sLSTM), recurrentgemma-9b (RG-LRU + local
attention), llama-3.2-vision-11b (gated cross-attention),
deepseek-v2-lite-16b and deepseek-v2-236b (MoE experts over ``model`` +
MLA heads; the 236b's ``q_lora``) and musicgen-medium (embedding inputs,
layernorm with bias, the gelu MLP): each family's f32 smoke config on
meshes (data 2, model 2) and (data 1, model 4), from the reference's
initial parameters (carried by ``convert``; the cross layers' gates set
nonzero so they act) and numpy-seeded batches, 2 plain-SGD steps (lr 1,
so each change is the gradient itself; see ``test_torch_lm_sharded_train``
(c)) in 2 microbatches with RSC (bk 32, keep 0.5). Four gloo ranks on the
CPU are spawned once and run every case while the reference's jitted
steps compile in a thread beside them. Asserted, per family and mesh:

* the blocks each RSC'd linear selects per microbatch equal the
  reference's, on every rank;
* the losses within 1e-5 relative of the reference's (or twice the
  reference's own move from weights one unit in the last place away,
  where that is more: the xLSTM smoke model's second loss moves ~8e-5
  that way);
* each parameter's change within ``test_torch_lm_sharded_train``'s
  ``_changes_close`` limits (1e-3 of the reference's change in L2 norm,
  or twice the nudged run's own move);
* MoE: every rank's expert ids, and the positions within their experts,
  equal the reference's routing of the rank's rows (the reference's ids
  recorded from its ``top_k`` in an eager forward at each step's
  parameters, its positions counted here from them);
* every rank's trained parameter blocks, and the Adam moments it would
  keep over them, have the shape its spec gives.

The four dense architectures run on the same two meshes, one step each,
against the port's one-process step (itself held against the reference
in ``test_torch_lm_train.py`` and ``test_torch_lm_families_train.py``):
equal selected blocks, the loss within 1e-5 relative, each change within
1e-3 of the one-process change in L2 norm.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import make_batch
from repro_torch.distributed.group import launch, plan_group
from repro_torch.launch.mesh import Mesh
from repro_torch.train.lm_steps import local_batch, \
    make_sharded_train_step, make_train_step
from repro_torch.train.optimizer import Adam
from tests.test_torch_lm_sharded_train import FAMILIES, RSC, SGD, B, T, \
    _cfg, _changes_close, _gated, _init_tree, _jax, _jax_sgd, _nudged, \
    _recording, _reference_runs, _shapes

MESHES = [(2, 2), (1, 4)]
STEPS, N_MB = 2, 2
MOE = [a for a in FAMILIES if a.startswith("deepseek")]
DENSE_ALL = ["qwen3-1.7b", "qwen2-0.5b", "qwen3-32b", "internlm2-20b"]


# ------------------------------------------------------------ ranks
def _route_recording():
    """Record the expert ids and positions of every MoE routing of the
    forward (not its recomputation in the backward)."""
    import repro_torch.models.lm.moe as mod
    log, inner = [], mod.route

    def route(p, cfg, x):
        r = inner(p, cfg, x)
        if torch._C._current_graph_task_id() == -1:
            log.append((r["expert"].tolist(), r["pos"].tolist()))
        return r
    mod.route = route
    return log


def rank_main(group, trees: dict) -> dict:
    torch.manual_seed(0)
    sel_log, route_log = _recording(), _route_recording()
    meshes = {m: Mesh(m, ("data", "model")).bind("cpu") for m in MESHES}
    out = {}
    for arch in FAMILIES + DENSE_ALL:
        cfg = _cfg(arch)
        for m, mesh in meshes.items():
            state = convert.lm_sharded_from_numpy(cfg, trees[arch], mesh,
                                                  "cpu")
            opt = SGD()
            ost = opt.init(state.shards)
            step = make_sharded_train_step(cfg, opt, mesh, N_MB, RSC)
            sel_log.clear()
            route_log.clear()
            losses = []
            for i in range(STEPS if arch in FAMILIES else 1):
                batch = make_batch(cfg, "train_4k", B, T, seed=i)
                state, ost, loss = step(state, ost,
                                        local_batch(batch, mesh, N_MB))
                losses.append(float(loss))
            out[(arch, m)] = {
                "losses": losses, "sel": list(sel_log),
                "routes": list(route_log),
                "data_index": mesh.index(mesh.dp_axes),
                "shapes": _shapes(state, Adam().init(state.shards)),
                "params": convert.lm_sharded_to_numpy(state)}
    return out


# ------------------------------------------------------------ reference
def _reference_routing(arch, starts: list) -> list:
    """The reference's expert ids (rows, t·k) of every MoE layer of each
    microbatch of each step, in the order the step runs them, from an
    eager forward at the step's parameters (``starts[i]``): its ``top_k``
    is recorded through the ``jax`` name of ``repro.models.lm.moe``."""
    jax, _, jmb, jsc, _, _ = _jax()
    import repro.models.lm.moe as jmoe
    from repro.models.lm.backbone import forward
    # remat traces its layers even without jit: routing is the same
    cfg = dataclasses.replace(jsc(arch), dtype="float32", remat=False)
    log = []

    class Proxy:
        def __init__(self, inner, **over):
            self.__dict__.update(over)
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

    def top_k(x, k):
        w, e = jax.lax.top_k(x, k)
        log.append(np.asarray(e).reshape(e.shape[0], -1))
        return w, e
    jmoe.jax = Proxy(jax, lax=Proxy(jax.lax, top_k=top_k))
    out = []
    try:
        with jax.disable_jit():
            for i, params in enumerate(starts):
                # routing is per row: one forward of the whole batch,
                # then each microbatch's rows of every MoE layer
                batch = jmb(cfg, "train_4k", B, T, seed=i)
                log.clear()
                forward(params, cfg, mode="train",
                        **{k: v for k, v in batch.items() if k != "targets"})
                per = B // N_MB
                out += [e[j * per:(j + 1) * per] for j in range(N_MB)
                        for e in log]
    finally:
        jmoe.jax = jax
    return out


def _one_process(arch, tree) -> dict:
    """The port's one-process step from ``tree``: its loss, selected
    blocks and parameters."""
    cfg = _cfg(arch)
    net = convert.lm_params_from_numpy(cfg, tree, "cpu")
    opt = SGD()
    st = opt.init(dict(net.named_parameters()))
    step = make_train_step(cfg, opt, N_MB, RSC)
    mod = sys.modules["repro_torch.core.rsc_matmul"]
    inner, log = mod.top_blocks, []

    def top_blocks(scores, keep):
        idx = inner(scores, keep)
        log.append(idx.tolist())
        return idx
    mod.top_blocks = top_blocks
    try:
        net, st, loss = step(net, st, make_batch(cfg, "train_4k", B, T,
                                                 seed=0))
    finally:
        mod.top_blocks = inner
    return {"losses": [float(loss)], "sel": log,
            "params": convert.lm_params_to_numpy(net, cfg)}


def _positions(expert: np.ndarray) -> np.ndarray:
    """Each entry's position within its expert, per row: how many
    entries before it in the row picked the same expert."""
    pos = np.zeros_like(expert)
    for r, row in enumerate(expert):
        seen: dict = {}
        for j, e in enumerate(row):
            pos[r, j] = seen.get(e, 0)
            seen[e] = pos[r, j] + 1
    return pos


@pytest.fixture(scope="module")
def result():
    import threading
    trees = {a: _gated(_init_tree(a, 2)) for a in FAMILIES}
    trees.update({a: _init_tree(a, 2) for a in DENSE_ALL})
    box: dict = {}

    def references():
        try:
            ref = {a: _reference_runs([trees[a], _nudged(trees[a])], a,
                                      N_MB, True, None, STEPS, _jax_sgd())
                   for a in FAMILIES}
            box["ref"] = ref
            box["routes"] = {a: _reference_routing(
                a, [trees[a]] + ref[a][0]["params"][:STEPS - 1])
                for a in MOE}
        except BaseException as e:      # re-raised below
            box["error"] = e
    worker = threading.Thread(target=references)
    worker.start()
    try:
        ranks = launch(rank_main, (trees,),
                       plan=plan_group(4, force_host_devices=4, device="cpu"),
                       threads=1)
    finally:
        worker.join()
    if "error" in box:
        raise box["error"]
    return {"trees": trees, "ref": box["ref"], "routes": box["routes"],
            "ranks": ranks,
            "one_process": {a: _one_process(a, trees[a]) for a in DENSE_ALL}}


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_tensor_parallel_step_matches_reference(result, arch, mesh):
    ref, nudged = result["ref"][arch]
    runs = [r[(arch, mesh)] for r in result["ranks"]]
    got = runs[0]
    assert all(r["sel"] == got["sel"] for r in runs)
    assert got["sel"] == ref["sel"]
    for i in range(STEPS):
        own = abs(nudged["losses"][i] - ref["losses"][i]) \
            / abs(ref["losses"][i])
        np.testing.assert_allclose(got["losses"][i], ref["losses"][i],
                                   rtol=max(1e-5, 2 * own))
    _changes_close(got["params"], ref["params"][STEPS - 1],
                   result["trees"][arch], nudged["params"][STEPS - 1])
    if arch in MOE:
        want = result["routes"][arch]
        n_moe = _cfg(arch).layer_plan().count("attn_moe")
        assert len(want) == STEPS * N_MB * n_moe
        for r in runs:
            assert len(r["routes"]) == len(want)
            rows = B // N_MB // mesh[0]
            lo = r["data_index"] * rows
            for (expert, pos), full in zip(r["routes"], want):
                mine = full[lo:lo + rows]
                np.testing.assert_array_equal(expert, mine)
                np.testing.assert_array_equal(pos, _positions(mine))


# ------------------------------------------------------------ blocks
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_blocks_are_the_specs_share(result, arch, mesh):
    cfg = _cfg(arch)
    specs = convert.lm_param_shardings(cfg, Mesh(mesh, ("data", "model")))
    n, split = 0, 0
    for r in result["ranks"]:
        for name, p, m, v, want in r[(arch, mesh)]["shapes"]:
            assert p == m == v == want, name
            n += 1
            split += "model" in specs[name].spec
    assert n == 4 * len(specs)
    assert split > 0     # tensor parallel: some blocks split over model


# ------------------------------------------------------------ dense
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", DENSE_ALL)
def test_dense_architecture_runs_on_both_meshes(result, arch, mesh):
    want = result["one_process"][arch]
    runs = [r[(arch, mesh)] for r in result["ranks"]]
    assert all(r["sel"] == want["sel"] for r in runs)
    assert len(want["sel"]) == 3 * 2 * N_MB      # 3 linears, 2 layers
    np.testing.assert_allclose(runs[0]["losses"], want["losses"], rtol=1e-5)
    _changes_close(runs[0]["params"], want["params"], result["trees"][arch])
