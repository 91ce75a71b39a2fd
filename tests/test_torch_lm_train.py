"""The port's LM training slice against the reference: training attention
and its gradients, ``forward(mode="train")`` with and without RSC,
``cross_entropy``, Adam, a 3-step training trajectory from shared initial
parameters, the prefill-vs-teacher-forced rule, and the ``train lm`` entry
point.

Inputs and initial parameters are made by numpy (or the reference's init,
carried across with ``convert.lm_params_from_numpy``) and handed to both
packages. Tolerances: attention and its gradients in f32 at 1e-5; whole
models' logits at 1e-4·max|logit| and parameter gradients at rtol 1e-4 /
atol 1e-5·max|grad| (the two sum the same f32 products in different
orders, over more terms); the trajectory's losses within 1e-5 relative and
each parameter's change within 1e-3 of the reference's change in L2 norm
(Adam moves each element by about lr whatever its gradient, so a limit on
the parameters themselves could not see a wrong dW; one that drops one of
its two selected blocks misses the change by about 0.7 of its norm); bf16
prefill against the teacher-forced forward at atol 2e-2 / rtol 1e-2, the
rule of ``tests/test_lm_archs.py``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import make_batch as jax_make_batch
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.shapes import MICROBATCHES as JAX_MICROBATCHES
from repro.models.lm import attention as jax_attn
from repro.models.lm.backbone import forward as jax_forward
from repro.models.lm.backbone import init_params as jax_init_params
from repro.train import optimizer as jax_opt
from repro.train.lm_steps import cross_entropy as jax_cross_entropy
from repro.train.lm_steps import make_train_step as jax_make_train_step
from repro_torch.configs import make_batch, smoke_config
from repro_torch.configs.shapes import MICROBATCHES, microbatches
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models.lm import attention
from repro_torch.models.lm.backbone import forward, init_params
from repro_torch.train import optimizer
from repro_torch.train.lm_steps import cross_entropy, make_prefill_step, \
    make_train_step

RSC = {"keep_frac": 0.5, "bk": 32}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _configs(arch, dtype="float32", local=False):
    repl = dict(dtype=dtype)
    if local:
        repl.update(pattern=("local", "attn"), n_layers=4)
    return (dataclasses.replace(smoke_config(arch), **repl),
            dataclasses.replace(jax_smoke_config(arch), **repl))


def _params(jcfg, cfg, seed=0):
    tree = jax.device_get(jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return tree, lm_params_from_numpy(cfg, tree, "cpu")


def _batches(cfg, jcfg, b, t, seed):
    ours = make_batch(cfg, "train_4k", b, t, seed=seed)
    ref = jax_make_batch(jcfg, "train_4k", b, t, seed=seed)
    return ours, ref


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("b,t,nq,nkv,hd,window,chunk,causal", [
    (2, 20, 4, 2, 16, None, 8, True),    # kv padded 20 -> 24
    (1, 24, 4, 4, 16, 6, 8, True),       # sliding window across chunks
    (2, 17, 4, 1, 8, None, 32, True),    # one chunk (chunk > tk), GQA 4:1
    (1, 12, 2, 2, 16, None, 5, False),   # no mask (q_positions None)
])
@pytest.mark.parametrize("remat", [True, False])
def test_training_attention_matches_reference(b, t, nq, nkv, hd, window,
                                              chunk, causal, remat):
    """Output and (dq, dk, dv) against ``jax.vjp`` of the reference's
    chunked ``flash_attention``, at 1e-5."""
    rng = np.random.default_rng(t + nq + hd)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, t, nq, hd), (b, t, nkv, hd), (b, t, nkv, hd)))
    ct = rng.standard_normal((b, t, nq, hd)).astype(np.float32)
    pos = np.arange(t, dtype=np.int32)
    kw = dict(window=window, chunk=chunk, remat_chunks=remat)

    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    out = attention.flash_attention(
        tq, tk, tv, q_positions=tpos if causal else None, kv_positions=tpos,
        **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(ct))

    jpos = jnp.asarray(pos)
    jout, vjp = jax.vjp(
        lambda a, bb, c: jax_attn.flash_attention(
            a, bb, c, q_positions=jpos if causal else None,
            kv_positions=jpos, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for ours, ref in zip(grads, jgrads):
        np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------ model

@pytest.mark.parametrize("arch,local", [("qwen3-1.7b", False),
                                        ("qwen2-0.5b", False),
                                        ("qwen3-1.7b", True)])
@pytest.mark.parametrize("rsc", [None, RSC])
def test_train_forward_and_grads_match_reference(arch, local, rsc):
    """f32 logits of ``forward(mode="train")`` and the gradient of the
    loss for every parameter, against ``jax.value_and_grad``."""
    cfg, jcfg = _configs(arch, "float32", local)
    tree, net = _params(jcfg, cfg, seed=1)
    batch, jbatch = _batches(cfg, jcfg, 2, 64, seed=3)
    logits, cache = forward(net, cfg, tokens=batch["tokens"], mode="train",
                            rsc=rsc)
    loss = cross_entropy(logits, batch["targets"])
    grads = torch.autograd.grad(loss, list(net.parameters()))

    def jloss(p):
        lg, _ = jax_forward(p, jcfg, tokens=jbatch["tokens"], mode="train",
                            rsc=rsc)
        return jax_cross_entropy(lg, jbatch["targets"]), lg
    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(tree)
    assert cache is None and logits.dtype == torch.float32
    scale = float(np.abs(np.asarray(jlogits)).max())
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    # carry the port's gradients into the reference's tree layout
    with torch.no_grad():
        for p, g in zip(net.parameters(), grads):
            p.copy_(g)
    ours = jax.tree.leaves(lm_params_to_numpy(net, cfg))
    ref = jax.tree.leaves(jgrads)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(o, r, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))


def test_rsc_keeps_the_forward_exact():
    """RSC changes only the weight gradients: the forward is the exact
    one (``tests/test_lm_archs.py::test_rsc_dense_backward_in_lm``)."""
    cfg = smoke_config("qwen2-0.5b")
    net = init_params(cfg, seed=0, device="cpu")
    tokens = make_batch(cfg, "train_4k", 2, 64)["tokens"]
    with torch.no_grad():
        exact, _ = forward(net, cfg, tokens=tokens, mode="train")
        sampled, _ = forward(net, cfg, tokens=tokens, mode="train", rsc=RSC)
    torch.testing.assert_close(sampled, exact, rtol=0, atol=0)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    targets = rng.integers(0, 50, (2, 7)).astype(np.int32)
    ours = cross_entropy(_t(logits), torch.from_numpy(targets))
    ref = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-0.5b"])
def test_prefill_matches_teacher_forced_forward(arch):
    """bf16: the last prefill logits equal the teacher-forced training
    forward's at the same position (``tests/test_lm_archs.py:64-93``)."""
    cfg = smoke_config(arch)
    net = init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, "prefill_32k", 1, 16, seed=1)
    logits_pf, _ = make_prefill_step(cfg)(net, batch)
    with torch.no_grad():
        ref, _ = forward(net, cfg, tokens=batch["tokens"], mode="train")
    np.testing.assert_allclose(_np(logits_pf[:, -1]), _np(ref[:, -1]),
                               atol=2e-2, rtol=1e-2)


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("clip,wd,dtype", [(None, 0.0, "float32"),
                                           (0.5, 0.0, "float32"),
                                           (1.0, 0.1, "bfloat16"),
                                           (None, 0.1, "bfloat16")])
def test_adam_matches_reference(clip, wd, dtype):
    """Three Adam steps on a two-leaf tree (one f32 norm-like leaf, one in
    ``dtype``): updates, moments and parameters, at 1e-6 (bf16 parameters
    compared exactly after the same f32 update is cast and added)."""
    rng = np.random.default_rng(1)
    p0 = {"g": rng.standard_normal(5).astype(np.float32),
          "w": rng.standard_normal((4, 3)).astype(np.float32)}
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    ours = {"g": _t(p0["g"]), "w": _t(p0["w"]).to(tdt)}
    ref = {"g": jnp.asarray(p0["g"]), "w": jnp.asarray(p0["w"], jdt)}
    opt = optimizer.Adam(lr=1e-2, weight_decay=wd, clip_norm=clip)
    jopt = jax_opt.Adam(lr=1e-2, weight_decay=wd, clip_norm=clip)
    st, jst = opt.init(ours), jopt.init(ref)
    for step in range(3):
        g = {k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in p0.items()}
        tg = {k: _t(v).to(ours[k].dtype) for k, v in g.items()}
        jg = {k: jnp.asarray(v, ref[k].dtype) for k, v in g.items()}
        upd, st = opt.update(tg, st, ours)
        jupd, jst = jopt.update(jg, jst, ref)
        optimizer.apply_updates(ours, upd)
        ref = jax_opt.apply_updates(ref, jupd)
        assert st["count"] == int(jst["count"]) == step + 1
        for k in p0:
            np.testing.assert_allclose(_np(upd[k]), np.asarray(jupd[k]),
                                       rtol=1e-6, atol=1e-9)
            for mom in ("m", "v"):
                np.testing.assert_allclose(_np(st[mom][k]),
                                           np.asarray(jst[mom][k]),
                                           rtol=1e-6, atol=1e-9)
            assert ours[k].dtype == tdt if k == "w" else torch.float32
            np.testing.assert_allclose(_np(ours[k]), _np(ref[k]), rtol=1e-6,
                                       atol=1e-9)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal(6).astype(np.float32),
         "b": rng.standard_normal((3, 2)).astype(np.float32)}
    ours, gn = optimizer.clip_by_global_norm({k: _t(v).bfloat16()
                                              for k, v in g.items()}, 0.5)
    ref, jgn = jax_opt.clip_by_global_norm(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}, 0.5)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for k in g:
        assert ours[k].dtype == torch.float32 == \
            getattr(torch, str(ref[k].dtype))
        np.testing.assert_allclose(_np(ours[k]), np.asarray(ref[k]),
                                   rtol=1e-6)


# ------------------------------------------------------------ trajectory

@pytest.mark.parametrize("n_mb", [1, 2])
@pytest.mark.parametrize("rsc", [None, RSC])
def test_train_trajectory_matches_reference(n_mb, rsc):
    """Three steps of ``make_train_step`` (f32 smoke qwen3-1.7b, Adam with
    the CLI's clip 1.0) from the reference's initial parameters: losses
    within 1e-5 relative, then every parameter's change within 1e-3 of the
    reference's change (L2 norms)."""
    cfg, jcfg = _configs("qwen3-1.7b")
    tree, net = _params(jcfg, cfg, seed=2)
    start = [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]
    lr, steps = 1e-3, 3
    opt, jopt = optimizer.Adam(lr=lr, clip_norm=1.0), \
        jax_opt.Adam(lr=lr, clip_norm=1.0)
    st, jst = opt.init(dict(net.named_parameters())), jopt.init(tree)
    step = make_train_step(cfg, opt, n_mb, rsc=rsc)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, n_mb, rsc=rsc))
    ops.reset_launch_counts()
    for i in range(steps):
        batch, jbatch = _batches(cfg, jcfg, 4, 64, seed=i)
        net, st, loss = step(net, st, batch)
        tree, jst, jloss = jstep(tree, jst, jbatch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sum(ops.launch_counts().values()) == 0     # plain versions
    ours = jax.tree.leaves(lm_params_to_numpy(net, cfg))
    ref = jax.tree.leaves(tree)
    assert len(ours) == len(ref) == len(start)
    for o, r, p0 in zip(ours, ref, start):
        moved = np.asarray(r, np.float32) - p0
        assert np.linalg.norm((o - p0) - moved) <= 1e-3 * np.linalg.norm(moved)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-0.5b"])
def test_bf16_train_step_moves_params(arch):
    """bf16 smoke model, 2 microbatches with RSC: a finite loss, every
    parameter moves, dtypes are kept (``tests/test_lm_archs.py``'s train
    step smoke test)."""
    cfg = smoke_config(arch)
    net = init_params(cfg, seed=0, device="cpu")
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    opt = optimizer.Adam(lr=1e-3)
    step = make_train_step(cfg, opt, 2, rsc=RSC)
    batch = make_batch(cfg, "train_4k", 2, 64)
    net, _, loss = step(net, opt.init(dict(net.named_parameters())), batch)
    assert np.isfinite(float(loss))
    for k, p in net.named_parameters():
        assert p.dtype == before[k].dtype
        moved = (p.detach().float() - before[k].float()).abs().max()
        assert float(moved) > 0, k


def test_params_round_trip_through_numpy():
    cfg, jcfg = _configs("qwen2-0.5b", "float32", local=True)
    tree, net = _params(jcfg, cfg)
    back = lm_params_to_numpy(net, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_microbatch_table_equals_reference():
    assert MICROBATCHES == JAX_MICROBATCHES
    assert microbatches("qwen3-1.7b", "train_4k") == 2
    assert microbatches("qwen3-1.7b", "prefill_32k") == 1


# ------------------------------------------------------------ entry point

def test_train_cli_on_cpu(capsys):
    out = train.main(["lm", "--arch", "qwen3-1.7b", "--smoke", "--steps",
                      "3", "--batch", "4", "--seq", "64", "--microbatches",
                      "2", "--rsc", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"arch", "final_loss", "first_loss", "steps"}
    assert report["arch"] == "qwen3-1.7b-smoke" and report["steps"] == 3
    assert report == out["report"] and len(out["step_s"]) == 3
    assert all(np.isfinite(out["losses"]))


def test_train_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["lm", "--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("argv,item", [
    (["lm", "--arch", "deepseek-v2-lite-16b", "--smoke"], "item 9c"),
    # full-batch and minibatch training are ported for every model; the
    # data-parallel pools are item 8
    (["gnn", "--model", "graphsage", "--minibatch", "--epochs", "2",
      "--dp", "2"], "item 8"),
])
def test_train_cli_unported_parts_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        train.main(argv + ["--device", "cpu"] if argv[0] == "lm" else argv)
