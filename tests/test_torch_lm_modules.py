"""The port's LM modules of the other families against the reference, one
module at a time, from parameters carried across with
``convert.lm_params_from_numpy`` (each family's smoke config in f32):
MoE routing and experts, MLA (expanded prefill, absorbed decode), RG-LRU
(scan and step), mLSTM (chunkwise and recurrent, with carries), sLSTM and
gated cross-attention.

Tolerances: f32 at 1e-5 (the two packages sum the same f32 products in
other orders); routing slots and overflow masks equal. Where the port's
algorithm differs from the reference's, the difference is stated at the
test: the RG-LRU scan's tree order (1e-5 relative to the output's scale
over 4,096 steps), and the chunkwise mLSTM against the step recurrence
(5e-4 / 1e-3, the reference's own rule in ``tests/test_lm_cells.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.lm import attention as jax_attn
from repro.models.lm import layers as jax_layers
from repro.models.lm import mla as jax_mla
from repro.models.lm import moe as jax_moe
from repro.models.lm import rglru as jax_rglru
from repro.models.lm import xlstm as jax_xlstm
from repro.models.lm.backbone import init_params as jax_init_params
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.lm import attention, mla, moe, rglru, xlstm

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(_np(ours), _np(ref), **(tol or TOL))


@functools.lru_cache(maxsize=None)
def _family(arch, **repl):
    """The f32 smoke config in both packages, the reference's parameters
    (cross layers' ``ffn_gate`` 0.5 and ``gate`` -0.7, both 0 at init,
    where a cross layer adds nothing) and the port's module holding
    them."""
    repl = dict(repl, dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), **repl)
    jcfg = dataclasses.replace(jax_smoke_config(arch), **repl)
    tree = jax.tree.map(np.asarray, jax.device_get(
        jax_init_params(jax.random.PRNGKey(0), jcfg)))
    for blk in tree["blocks"]:
        if "ffn_gate" in blk:
            blk["ffn_gate"] = np.full_like(blk["ffn_gate"], 0.5)
            blk["attn"]["gate"] = np.full_like(blk["attn"]["gate"], -0.7)
    return cfg, jcfg, tree, lm_params_from_numpy(cfg, tree, "cpu")


def _ref_layer(tree, cfg, i):
    """The reference's parameters of layer ``i`` of ``cfg.layer_plan()``."""
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    if i < n_pre:
        return tree["prefix"][i]
    r, j = divmod(i - n_pre, n_pat)
    if r < cfg.repeats:
        return jax.tree.map(lambda a: a[r], tree["blocks"][j])
    return tree["suffix"][i - n_pre - cfg.repeats * n_pat]


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------------ MoE

def _jax_route(p, cfg, x):
    """The reference's routing (``repro/models/lm/moe.py``'s
    ``moe_apply``, its routing lines), which it does not return."""
    m = cfg.moe
    b, t, _ = x.shape
    probs = jax.nn.softmax(jax_layers.linear(p["router"],
                                             x.astype(jnp.float32)), -1)
    gate_w, gate_e = jax.lax.top_k(probs, m.top_k)
    fe = gate_e.reshape(b, t * m.top_k)
    order = jnp.argsort(fe, axis=1, stable=True)
    rank = jnp.argsort(order, axis=1)
    counts = jax.nn.one_hot(fe, m.n_routed, dtype=jnp.int32).sum(axis=1)
    starts = jnp.cumsum(counts, axis=1) - counts
    pos = rank - jnp.take_along_axis(starts, fe, axis=1)
    cap = min(t, max(1, -(-int(m.capacity_factor * t * m.top_k)
                          // m.n_routed)))
    overflow = pos >= cap
    return {"expert": fe, "weight": gate_w.reshape(b, t * m.top_k),
            "slot": jnp.where(overflow, m.n_routed, fe),
            "pos": jnp.where(overflow, 0, pos), "overflow": overflow,
            "cap": cap}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
@pytest.mark.parametrize("cf,zero_router", [(8.0, False), (0.5, False),
                                            (8.0, True), (0.5, True)],
                         ids=["dropless", "drops", "ties", "ties-drops"])
def test_moe_apply_matches_reference(arch, cf, zero_router):
    """Dropless (the smoke config's capacity factor 8), with drops (0.5),
    and with a zero router, where every probability ties and top-k must
    keep the lower experts first as ``lax.top_k`` does."""
    base = smoke_config(arch).moe
    cfg, jcfg, tree, net = _family(arch, moe=dataclasses.replace(
        base, capacity_factor=cf))
    i = cfg.layer_plan().index("attn_moe")
    p, jp = net.layers[i].moe, dict(_ref_layer(tree, cfg, i)["moe"])
    if zero_router:
        jp = dict(jp, router={"w": np.zeros_like(jp["router"]["w"])})
        p = moe.MoE(cfg, "cpu")
        p.load_state_dict(net.layers[i].moe.state_dict())
        with torch.no_grad():
            p.router.w.zero_()
    x = _x(int(cf * 10) + zero_router, 2, 24, cfg.d_model)
    r, jr = moe.route(p, cfg, _t(x)), _jax_route(jp, jcfg, jnp.asarray(x))
    assert r["cap"] == jr["cap"]
    for k in ("expert", "slot", "pos", "overflow"):
        np.testing.assert_array_equal(r[k].numpy(), np.asarray(jr[k]), k)
    _close(r["weight"], jr["weight"])
    n_drop = int(r["overflow"].sum())
    assert (n_drop == 0) == (cf == 8.0), n_drop
    if zero_router:        # ties: experts 0..k-1 in index order
        want = np.tile(np.arange(cfg.moe.top_k), 24)
        assert (r["expert"].numpy() == want).all()
    with torch.no_grad():
        out = moe.moe_apply(p, cfg, _t(x))
    _close(out, jax_moe.moe_apply(jp, jcfg, jnp.asarray(x)))


def test_moe_capacity_truncates_before_the_ceiling():
    """``int(cf·t·k)`` truncates before the ceiling division, and the
    capacity never exceeds t."""
    cfg = smoke_config("deepseek-v2-lite-16b")
    for cf, t, want in ((1.25, 10, 4), (0.3, 7, 1), (8.0, 24, 24),
                        (0.01, 5, 1), (1.1, 13, 4)):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        assert moe.capacity(c, t) == want, (cf, t)


# ------------------------------------------------------------------ MLA

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b"],
                         ids=["w_q", "q_lora"])
def test_mla_prefill_and_absorbed_decode(arch):
    cfg, jcfg, tree, net = _family(arch)
    assert (cfg.mla.q_lora is not None) == (arch == "deepseek-v2-236b")
    p, jp = net.layers[0].attn, _ref_layer(tree, cfg, 0)["attn"]
    assert hasattr(p, "w_dq") == (cfg.mla.q_lora is not None)
    b, t, max_len = 2, 20, 24
    x = _x(1, b, t + 3, cfg.d_model)
    pos = np.arange(t, dtype=np.int32)
    with torch.no_grad():
        out, cache = mla.mla_attention(p, cfg, _t(x[:, :t]),
                                       torch.from_numpy(pos), mode="prefill")
        train_out, none = mla.mla_attention(p, cfg, _t(x[:, :t]),
                                            torch.from_numpy(pos))
    jout, jcache = jax_mla.mla_attention(jp, jcfg, jnp.asarray(x[:, :t]),
                                         jnp.asarray(pos), mode="prefill")
    _close(out, jout)
    _close(train_out, jout)
    assert none is None and sorted(cache) == sorted(jcache) == \
        ["ckv", "krope"]
    for k in jcache:
        _close(cache[k], jcache[k])
        grown = np.zeros((b, max_len, jcache[k].shape[-1]), np.float32)
        grown[:, :t] = np.asarray(jcache[k])
        cache[k], jcache[k] = _t(grown), jnp.asarray(grown)
    for n in range(t, t + 3):
        with torch.no_grad():
            out, cache = mla.mla_attention(
                p, cfg, _t(x[:, n:n + 1]), torch.tensor([n], dtype=torch.int32),
                cache=cache, cache_len=n, mode="decode")
        jout, jcache = jax_mla.mla_attention(
            jp, jcfg, jnp.asarray(x[:, n:n + 1]), jnp.asarray([n], jnp.int32),
            cache=jcache, cache_len=jnp.asarray(n, jnp.int32), mode="decode")
        _close(out, jout)
        for k in jcache:
            _close(cache[k], jcache[k])


# ------------------------------------------------------------------ RG-LRU

def test_rglru_block_scan_and_step():
    """Prefill (scan) then 3 decode steps (step form) of the block, and
    the training forward, against the reference."""
    cfg, jcfg, tree, net = _family("recurrentgemma-9b")
    p, jp = net.layers[0].rec, _ref_layer(tree, cfg, 0)["rec"]
    assert p.get_parameter("lambda").dtype == torch.float32
    b, t = 2, 20
    x = _x(2, b, t + 3, cfg.d_model)
    with torch.no_grad():
        out, cache = rglru.rglru_block(p, cfg, _t(x[:, :t]), mode="prefill")
        train_out, _ = rglru.rglru_block(p, cfg, _t(x[:, :t]))
    jout, jcache = jax_rglru.rglru_block(jp, jcfg, jnp.asarray(x[:, :t]),
                                         mode="prefill")
    _close(out, jout)
    _close(train_out, jout)
    for n in range(t, t + 3):
        for k in jcache:
            _close(cache[k], jcache[k])
        with torch.no_grad():
            out, cache = rglru.rglru_block(p, cfg, _t(x[:, n:n + 1]),
                                           cache=cache, mode="decode")
        jout, jcache = jax_rglru.rglru_block(
            jp, jcfg, jnp.asarray(x[:, n:n + 1]), cache=jcache,
            mode="decode")
        _close(out, jout)


@pytest.mark.parametrize("t", [24, 4096])
def test_rglru_scan_long_against_reference_and_step(t):
    """The log-depth scan over up to 4,096 positions (recurrentgemma's
    prompt) against the reference's ``associative_scan`` and against the
    step recurrence ``h = a·h + g`` run position by position on the same
    gates (at t = 24 through ``_rg_lru_step`` itself). The three combine
    the same f32 products in other orders: within 1e-5 of the output's
    scale against the reference, 1e-4 / 1e-3 against the step form, the
    rule of the reference's own scan-vs-step test."""
    cfg, jcfg, tree, net = _family("recurrentgemma-9b")
    p, jp = net.layers[0].rec, _ref_layer(tree, cfg, 0)["rec"]
    x = _x(t, 2, t, cfg.lru_width, scale=0.5)
    with torch.no_grad():
        y, h = rglru._rg_lru_scan(p, _t(x))
        h_step, ys = torch.zeros(2, cfg.lru_width), []
        if t <= 64:
            for i in range(t):
                yi, h_step = rglru._rg_lru_step(p, _t(x[:, i:i + 1]), h_step)
                ys.append(yi[:, 0])
        else:
            a, g = rglru._gates(p, _t(x))
            for i in range(t):
                h_step = a[:, i] * h_step + g[:, i]
                ys.append(h_step)
    jy, jh = jax_rglru._rg_lru_scan(jp, jnp.asarray(x))
    scale = float(np.abs(np.asarray(jy)).max())
    _close(y, jy, rtol=1e-5, atol=1e-5 * scale)
    _close(h, jh, rtol=1e-5, atol=1e-5 * scale)
    _close(y, torch.stack(ys, 1), rtol=1e-3, atol=1e-4)
    _close(h, h_step, rtol=1e-3, atol=1e-4)


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(0)
    for t in (1, 2, 3, 7, 64, 100):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, t, 3)).astype(
            np.float64))
        b = torch.from_numpy(rng.standard_normal((2, t, 3)))
        h, want = torch.zeros(2, 3, dtype=torch.float64), []
        for i in range(t):
            h = a[:, i] * h + b[:, i]
            want.append(h)
        torch.testing.assert_close(rglru.linear_scan(a, b),
                                   torch.stack(want, 1), rtol=1e-12,
                                   atol=1e-12)


# ------------------------------------------------------------------ mLSTM

def _mlstm_inputs(seed, b, t, nh, dk, dv):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, nh, d)).astype(np.float32)
               for d in (dk, dk, dv))
    ig = (rng.standard_normal((b, t, nh)) * 2).astype(np.float32)
    fg = (rng.standard_normal((b, t, nh)) * 3).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunkwise_matches_reference_and_recurrent(chunk):
    """``tests/test_lm_cells.py``'s chunkwise-vs-recurrent case on the
    port, and both forms against the reference's (1e-5)."""
    args = _mlstm_inputs(chunk, 2, 64, 2, 8, 8)
    ours = [_t(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    h1, c1 = xlstm.mlstm_recurrent(*ours)
    h2, c2 = xlstm.mlstm_chunkwise(*ours, chunk=chunk)
    jh1, jc1 = jax_xlstm.mlstm_recurrent(*jargs)
    jh2, jc2 = jax_xlstm.mlstm_chunkwise(*jargs, chunk=chunk)
    _close(h1, jh1)
    _close(h2, jh2)
    for a, b, ja, jb in zip(c1, c2, jc1, jc2):
        _close(a, ja)
        _close(b, jb)
    _close(h1, h2, atol=5e-4, rtol=1e-3)
    for a, b in zip(c1, c2):
        _close(a, b, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("chunk", [8, 12])
def test_mlstm_carry_continuation(chunk):
    """A chunked prefill's carry continued by the recurrence equals one
    long recurrence, and equals the reference's continuation."""
    args = _mlstm_inputs(5, 1, 32, 2, 8, 8)
    ours = [_t(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    h_all, _ = xlstm.mlstm_recurrent(*ours)
    _, carry = xlstm.mlstm_chunkwise(*(a[:, :24] for a in ours), chunk=chunk)
    _, jcarry = jax_xlstm.mlstm_chunkwise(*(a[:, :24] for a in jargs),
                                          chunk=chunk)
    for a, ja in zip(carry, jcarry):
        _close(a, ja)
    h_tail, _ = xlstm.mlstm_recurrent(*(a[:, 24:] for a in ours),
                                      carry=carry)
    _close(h_all[:, 24:], h_tail, atol=5e-4, rtol=1e-3)
    # a chunkwise continuation from the carry, as a second prefill would
    h_more, _ = xlstm.mlstm_chunkwise(*(a[:, 24:] for a in ours), chunk=8,
                                      carry=carry)
    jh_more, _ = jax_xlstm.mlstm_chunkwise(*(a[:, 24:] for a in jargs),
                                           chunk=8, carry=jcarry)
    _close(h_more, jh_more)


def test_mlstm_chunk_must_divide_t():
    """The reference asserts ``t % chunk == 0``; the port raises the same
    way and does not pad."""
    args = [_t(a) for a in _mlstm_inputs(0, 1, 24, 2, 8, 8)]
    with pytest.raises(AssertionError):
        xlstm.mlstm_chunkwise(*args, chunk=16)


def test_mlstm_block_prefill_and_decode():
    cfg, jcfg, tree, net = _family("xlstm-125m")
    i = cfg.layer_plan().index("mlstm")
    p, jp = net.layers[i].cell, _ref_layer(tree, cfg, i)["cell"]
    b, t = 2, 16
    x = _x(3, b, t + 3, cfg.d_model)
    with torch.no_grad():
        out, cache = xlstm.mlstm_block(p, cfg, _t(x[:, :t]), mode="prefill")
    jout, jcache = jax_xlstm.mlstm_block(jp, jcfg, jnp.asarray(x[:, :t]),
                                         mode="prefill")
    _close(out, jout)
    assert cache["m"].dtype == cache["C"].dtype == torch.float32
    for n in range(t, t + 3):
        for k in jcache:
            _close(cache[k], jcache[k])
        with torch.no_grad():
            out, cache = xlstm.mlstm_block(p, cfg, _t(x[:, n:n + 1]),
                                           cache=cache, mode="decode")
        jout, jcache = jax_xlstm.mlstm_block(
            jp, jcfg, jnp.asarray(x[:, n:n + 1]), cache=jcache,
            mode="decode")
        _close(out, jout)


# ------------------------------------------------------------------ sLSTM

def test_slstm_block_prefill_and_decode():
    cfg, jcfg, tree, net = _family("xlstm-125m")
    i = cfg.layer_plan().index("slstm")
    p, jp = net.layers[i].cell, _ref_layer(tree, cfg, i)["cell"]
    b, t = 2, 16
    x = _x(4, b, t + 3, cfg.d_model)
    with torch.no_grad():
        out, cache = xlstm.slstm_block(p, cfg, _t(x[:, :t]), mode="prefill")
        train_out, none = xlstm.slstm_block(p, cfg, _t(x[:, :t]))
    jout, jcache = jax_xlstm.slstm_block(jp, jcfg, jnp.asarray(x[:, :t]),
                                         mode="prefill")
    _close(out, jout)
    _close(train_out, jout)
    assert none is None
    for n in range(t, t + 3):
        for k in jcache:
            assert cache[k].dtype == torch.float32
            _close(cache[k], jcache[k])
        with torch.no_grad():
            out, cache = xlstm.slstm_block(p, cfg, _t(x[:, n:n + 1]),
                                           cache=cache, mode="decode")
        jout, jcache = jax_xlstm.slstm_block(
            jp, jcfg, jnp.asarray(x[:, n:n + 1]), cache=jcache,
            mode="decode")
        _close(out, jout)


# ------------------------------------------------------- cross-attention

@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_cross_attention_with_nonzero_gates(mode):
    """The tanh-gated cross-attention with ``gate`` = -0.7 (0 at init,
    where the layer adds nothing): the prefill's output and cached k/v,
    then 2 decode steps that read the cache."""
    cfg, jcfg, tree, net = _family("llama-3.2-vision-11b")
    i = cfg.layer_plan().index("cross")
    p, jp = net.layers[i].attn, _ref_layer(tree, cfg, i)["attn"]
    assert float(p.gate) == float(jp["gate"]) == np.float32(-0.7)
    b, t = 2, 12
    x = _x(6, b, t + 2, cfg.d_model)
    cs = _x(7, b, cfg.cross_seq, cfg.d_model)
    with torch.no_grad():
        out, cache = attention.cross_attention(p, cfg, _t(x[:, :t]), _t(cs),
                                               mode=mode)
    jout, jcache = jax_attn.cross_attention(jp, jcfg, jnp.asarray(x[:, :t]),
                                            jnp.asarray(cs), mode=mode)
    _close(out, jout)
    assert float(np.abs(_np(out)).max()) > 0.1
    if mode == "train":
        assert cache is None and jcache is None
        return
    for k in ("k", "v"):
        _close(cache[k], jcache[k])
    for n in range(t, t + 2):
        with torch.no_grad():
            out, cache = attention.cross_attention(
                p, cfg, _t(x[:, n:n + 1]), None, cache=cache, mode="decode")
        jout, jcache = jax_attn.cross_attention(
            jp, jcfg, jnp.asarray(x[:, n:n + 1]), None, cache=jcache,
            mode="decode")
        _close(out, jout)


# ------------------------------------------------------------ activations

@pytest.mark.parametrize("name", ["sigmoid", "silu", "gelu"])
def test_activations_round_like_the_reference(name):
    """In bf16 on the CPU each activation evaluates ``jax.nn``'s op graph
    and gives the reference's bits (PyTorch's fused ops round once and
    differ in the last place on many inputs); in f32 the fused ops agree
    to f32 rounding."""
    from repro_torch.models.lm import layers
    x = _x(9, 4096, scale=3.0)
    ours, ref = getattr(layers, name), getattr(jax.nn, name)
    got = ours(torch.from_numpy(x).to(torch.bfloat16))
    want = jax.jit(ref)(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    _close(ours(_t(x)), ref(jnp.asarray(x)), rtol=1e-6, atol=1e-6)
