"""The port's LM serving slice against the reference: configs, batches,
layers, attention with its caches, and prefill + greedy decode end to end
from parameters carried across with ``convert.lm_params_from_numpy``.

Tolerances: layers and attention in f32 at 1e-5; the whole model in f32 at
1e-4·max|logit| with identical greedy tokens (the two packages sum the
same f32 products in different orders); in bf16 at least 95 % of logits
within atol 2e-2 / rtol 1e-2 and the same top-1, the rule of
``tests/test_lm_archs.py`` (bf16 rounds at other places in each package).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.configs import make_batch as jax_make_batch
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import greedy_generate as jax_greedy_generate
from repro.models.lm import attention as jax_attn
from repro.models.lm import layers as jax_layers
from repro.models.lm.backbone import init_cache as jax_init_cache
from repro.models.lm.backbone import init_params as jax_init_params
from repro.train.lm_steps import make_decode_step as jax_make_decode_step
from repro.train.lm_steps import make_prefill_step as jax_make_prefill_step
from repro_torch.configs import ARCHS, get_arch, make_batch, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import profile_serve, serve
from repro_torch.models.lm import attention, layers
from repro_torch.models.lm.backbone import forward, init_cache, init_params
from repro_torch.train.lm_steps import make_decode_step, make_prefill_step

DENSE = ["qwen3-1.7b", "qwen2-0.5b"]


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _configs(arch, dtype="float32", local=False):
    """The same reduced config in both packages; ``local`` makes every
    second layer a 16-wide sliding window."""
    repl = dict(dtype=dtype)
    if local:
        repl.update(pattern=("local", "attn"), n_layers=4)
    return (dataclasses.replace(smoke_config(arch), **repl),
            dataclasses.replace(jax_smoke_config(arch), **repl))


def _params(jcfg, cfg, seed=0):
    tree = jax.device_get(jax_init_params(jax.random.PRNGKey(seed), jcfg))
    return tree, lm_params_from_numpy(cfg, tree, "cpu")


# ------------------------------------------------------------ configs, data

@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_configs_equal_the_reference(arch):
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for ours, ref in ((get_arch(arch), jax_get_arch(arch)),
                      (smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.layer_plan() == ref.layer_plan()
        assert (ours.hd, ours.repeats, ours.param_count()) == \
            (ref.hd, ref.repeats, ref.param_count())


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-1.7b", "prefill_32k"), ("qwen2-0.5b", "train_4k"),
    ("internlm2-20b", "decode_32k")])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_batch_tokens_bit_identical(arch, shape, seed):
    ours = make_batch(smoke_config(arch), shape, 3, 11, seed=seed)
    ref = jax_make_batch(jax_smoke_config(arch), shape, 3, 11, seed=seed)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == torch.int32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    g = (1 + 0.3 * rng.standard_normal(24)).astype(np.float32)
    b = (0.2 * rng.standard_normal(24)).astype(np.float32)
    p = layers.Norm(24, kind)
    jp = {"g": jnp.asarray(g)}
    with torch.no_grad():
        p.g.copy_(_t(g))
        if kind == "layernorm":
            p.b.copy_(_t(b))
            jp["b"] = jnp.asarray(b)
    np.testing.assert_allclose(
        _np(layers.apply_norm(p, _t(x), 1e-6)),
        np.asarray(jax_layers.apply_norm(jp, jnp.asarray(x), 1e-6)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (64, 1e6), (128, 1e6)])
def test_apply_rope(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = np.array([0, 1, 2, 5, 8, 13, 100, 1000, 4095], np.int32)
    np.testing.assert_allclose(
        _np(layers.apply_rope(_t(x), torch.from_numpy(pos), theta)),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(kind):
    rng = np.random.default_rng(1)
    d, d_ff = 16, 40
    p = layers.MLP(d, d_ff, kind, torch.float32, "cpu")
    jp = {}
    with torch.no_grad():
        for name in ("gate", "up", "down"):
            lin = getattr(p, name)
            if lin is None:
                continue
            w = (rng.standard_normal(tuple(lin.w.shape)) * 0.3).astype(
                np.float32)
            lin.w.copy_(_t(w))
            jp[name] = {"w": jnp.asarray(w)}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    np.testing.assert_allclose(
        _np(layers.mlp_apply(p, _t(x), kind)),
        np.asarray(jax_layers.mlp_apply(jp, jnp.asarray(x), kind)),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("window", [None, 16])
def test_self_attention_prefill_and_decode(arch, window):
    """Prefill (cache built, ring buffer wrapped when t > window), then two
    decode steps against the cache grown to ``max_len``."""
    cfg, jcfg = _configs(arch)
    tree, net = _params(jcfg, cfg)
    p, jp = net.layers[0].attn, jax.tree.map(lambda a: a[0],
                                             tree["blocks"][0]["attn"])
    b, t, max_len = 2, 20, 24
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, t + 2, cfg.d_model)).astype(np.float32)
    pos = np.arange(t, dtype=np.int32)
    kw = dict(window=window)
    out, cache = attention.self_attention(
        p, cfg, _t(x[:, :t]), torch.from_numpy(pos), mode="prefill", **kw)
    jout, jcache = jax_attn.self_attention(
        jp, jcfg, jnp.asarray(x[:, :t]), jnp.asarray(pos), mode="prefill",
        **kw)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    assert sorted(cache) == sorted(jcache)
    for k in jcache:
        np.testing.assert_allclose(_np(cache[k]), np.asarray(jcache[k],
                                                             np.float32),
                                   rtol=1e-5, atol=1e-5)
    if window is None:   # grow to max_len, as the serving driver does
        for k in ("k", "v"):
            grown = np.zeros((b, max_len) + jcache[k].shape[2:], np.float32)
            grown[:, :t] = np.asarray(jcache[k])
            cache[k] = _t(grown)
            jcache[k] = jnp.asarray(grown)
    for step in range(2):
        n = t + step
        xs = x[:, n:n + 1]
        out, cache = attention.self_attention(
            p, cfg, _t(xs), torch.tensor([n], dtype=torch.int32),
            cache=cache, cache_len=n, mode="decode", **kw)
        jout, jcache = jax_attn.self_attention(
            jp, jcfg, jnp.asarray(xs), jnp.asarray([n], jnp.int32),
            cache=jcache, cache_len=jnp.asarray(n, jnp.int32), mode="decode",
            **kw)
        np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5,
                                   atol=1e-5)
        for k in jcache:
            np.testing.assert_allclose(_np(cache[k]),
                                       np.asarray(jcache[k], np.float32),
                                       rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ end to end

def _run(prefill, decode, params, tokens, n_decode, grow, to_tok, argmax):
    """Prefill + ``n_decode`` greedy steps; returns logits per step (numpy)
    and the tokens chosen."""
    logits, cache = prefill(params, {"tokens": tokens})
    cache = grow(cache)
    outs, toks = [_np(logits)], []
    for _ in range(n_decode):
        tok = argmax(logits)
        toks.append(np.asarray(tok))
        logits, cache = decode(params, cache, {"tokens": to_tok(tok)})
        outs.append(_np(logits))
    return outs, np.concatenate(toks, 1)


@pytest.mark.parametrize("arch,local", [("qwen3-1.7b", False),
                                        ("qwen2-0.5b", False),
                                        ("qwen3-1.7b", True)])
def test_prefill_decode_f32_matches_reference(arch, local):
    cfg, jcfg = _configs(arch, "float32", local)
    tree, net = _params(jcfg, cfg, seed=1)
    b, t, n_dec = 2, 24, 6
    max_len = t + n_dec + 1
    tokens = make_batch(cfg, "prefill_32k", b, t, seed=2)["tokens"]
    jtokens = jax_make_batch(jcfg, "prefill_32k", b, t, seed=2)["tokens"]

    def grow(cache):
        return serve.graft(cfg, cache, b, max_len, "cpu")

    def jgrow(cache):
        full = jax_init_cache(jcfg, b, max_len)
        return jax.tree.map(
            lambda d, s: s if d.shape == s.shape
            else d.at[tuple(slice(0, n) for n in s.shape)].set(s),
            full, cache)

    ours, toks = _run(make_prefill_step(cfg), make_decode_step(cfg), net,
                      tokens, n_dec, grow, lambda x: x,
                      lambda l: l[:, -1].argmax(-1).to(torch.int32)[:, None])
    ref, jtoks = _run(jax.jit(jax_make_prefill_step(jcfg)),
                      jax.jit(jax_make_decode_step(jcfg)), tree, jtokens,
                      n_dec, jgrow, jnp.asarray,
                      lambda l: np.asarray(jnp.argmax(l[:, -1], -1),
                                           np.int32)[:, None])
    np.testing.assert_array_equal(toks, jtoks)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape == (b, 1, cfg.vocab)
        np.testing.assert_allclose(o, r, rtol=0,
                                   atol=1e-4 * float(np.abs(r).max()))

    # the serving driver of both packages picks the same tokens
    gen, _, record = serve.greedy_generate(cfg, net, {"tokens": tokens},
                                           max_len, n_dec)
    jgen, _ = jax_greedy_generate(jcfg, tree, {"tokens": jtokens}, max_len,
                                  n_dec)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    assert record["launches"]["prefill"]["flash_attention"] == 0  # CPU


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_bf16_matches_reference(arch):
    cfg, jcfg = _configs(arch, "bfloat16")
    tree, net = _params(jcfg, cfg, seed=2)
    b, t = 2, 16
    tokens = make_batch(cfg, "prefill_32k", b, t, seed=3)["tokens"]
    jtokens = jax_make_batch(jcfg, "prefill_32k", b, t, seed=3)["tokens"]
    logits, cache = make_prefill_step(cfg)(net, {"tokens": tokens})
    jlogits, jcache = jax.jit(jax_make_prefill_step(jcfg))(
        tree, {"tokens": jtokens})
    # one decode step on the same token in both
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
    cache = serve.graft(cfg, cache, b, t + 2, "cpu")
    full = jax_init_cache(jcfg, b, t + 2)
    jcache = jax.tree.map(
        lambda d, s: s if d.shape == s.shape
        else d.at[tuple(slice(0, n) for n in s.shape)].set(s), full, jcache)
    dec, _ = make_decode_step(cfg)(net, cache,
                                   {"tokens": torch.from_numpy(tok.copy())})
    jdec, _ = jax.jit(jax_make_decode_step(jcfg))(tree, jcache,
                                                  {"tokens": jnp.asarray(tok)})
    for o, r in ((logits, jlogits), (dec, jdec)):
        a, r = _np(o)[:, -1], np.asarray(r, np.float32)[:, -1]
        close = np.isclose(a, r, atol=2e-2, rtol=1e-2).mean()
        assert close > 0.95, close
        np.testing.assert_array_equal(a.argmax(-1), r.argmax(-1))


# ------------------------------------------------------------ entry point

def test_serve_cli_on_cpu(capsys):
    out = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--batch", "2",
                      "--prompt-len", "12", "--gen", "4", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    report = json.loads(line)
    assert set(report) == {"arch", "batch", "gen", "prefill_s", "decode_s",
                           "tok_per_s"}
    assert report["arch"] == "qwen3-1.7b-smoke"
    assert tuple(out["tokens"].shape) == (2, 4)
    assert np.isfinite(_np(out["logits"]["last"])).all()
    none = {"bcoo_spmm": 0, "gather_matmul": 0, "flash_attention": 0}
    assert out["launches"] == {"prefill": none, "decode": none}


def test_profile_serve_on_cpu(capsys):
    """The profiling script serves, then profiles a prefill and the asked
    number of decode steps; on the CPU no device time is recorded."""
    res = profile_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--batch",
                              "2", "--prompt-len", "12", "--gen", "3",
                              "--decode-steps", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["profile"] == res and set(res) == {"prefill", "decode"}
    assert res["decode"]["steps"] == 2
    for r in res.values():
        assert r["wall_ms"] > 0 and r["device_ms"] == 0 and r["top"] == []
    assert profile_serve.kernel_kind(
        "void (anonymous namespace)::flash_fwd_bf16<128>(Params)") == \
        "flash_attention"
    assert profile_serve.kernel_kind("nvjet_tst_192x192_64x3") == "matmul"


def test_serve_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke", "--gen", "2"])


def test_rsc_and_training_raise():
    """RSC and training are ported (tests/test_torch_lm_train.py); what
    they do not take still raises: an unknown rsc backend, an unknown
    mode."""
    cfg = smoke_config("qwen3-1.7b")
    net = init_params(cfg, seed=0, device="cpu")
    x = torch.zeros(1, 3, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="backend"):
        layers.mlp_apply(net.layers[0].mlp, x, cfg.mlp,
                         rsc={"keep_frac": 0.5, "backend": "pallas"})
    with pytest.raises(ValueError, match="mode"):
        forward(net, cfg, tokens=torch.zeros(1, 3, dtype=torch.int32),
                mode="score")


def test_init_is_seeded_and_shaped():
    cfg = smoke_config("qwen2-0.5b")
    a = init_params(cfg, seed=4, device="cpu")
    b = init_params(cfg, seed=4, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert not torch.equal(a.embed,
                           init_params(cfg, seed=5, device="cpu").embed)
    tree = jax.device_get(jax_init_params(jax.random.PRNGKey(0),
                                          jax_smoke_config("qwen2-0.5b")))
    ported = lm_params_from_numpy(cfg, tree, "cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  ported.named_parameters()):
        assert na == nb and pa.shape == pb.shape and pa.dtype == pb.dtype
    cache = init_cache(cfg, 2, 9, device="cpu")
    assert cache["len"] == 0 and len(cache["layers"]) == cfg.n_layers
    assert cache["layers"][0]["k"].shape == (2, 9, cfg.n_kv, cfg.hd)
