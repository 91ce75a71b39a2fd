"""The port's serving of the LM families beyond the dense one (xLSTM,
RecurrentGemma, Llama-3.2-Vision, DeepSeek-V2 Lite and 236B, MusicGen)
against the reference in f32, each through its smoke config with the
reference's parameters carried across by ``convert.lm_params_from_numpy``
(bf16: ``tests/test_torch_lm_families_bf16.py``).

Tolerances: f32 prefill + 8 greedy decode steps with the same tokens as
``repro.launch.serve.greedy_generate`` and every step's logits within
1e-4·max|logit| (the two packages sum the same f32 products in other
orders); the bf16 prefill against the port's own teacher-forced forward
at atol 2e-2 / rtol 1e-2 (MoE: 95 % of logits within it and the same
top-1), as ``tests/test_lm_archs.py`` holds the reference. Cross layers
run with ``ffn_gate`` 0.5 and ``gate`` -0.7 (both 0 at init, where such a
layer adds nothing).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import make_batch as jax_make_batch
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import greedy_generate as jax_greedy_generate
from repro.models.lm.backbone import init_cache as jax_init_cache
from repro.models.lm.backbone import init_params as jax_init_params
from repro.train.lm_steps import make_decode_step as jax_make_decode_step
from repro.train.lm_steps import make_prefill_step as jax_make_prefill_step
from repro_torch.configs import make_batch, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import profile_serve, serve
from repro_torch.models.lm.backbone import forward, init_cache, init_params
from repro_torch.train.lm_steps import make_decode_step, make_prefill_step

FAMILIES = ["xlstm-125m", "recurrentgemma-9b", "llama-3.2-vision-11b",
            "deepseek-v2-lite-16b", "deepseek-v2-236b", "musicgen-medium"]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _family(arch, dtype, seed=0):
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tree = jax.device_get(jax_init_params(jax.random.PRNGKey(seed), jcfg))
    for blk in tree["blocks"]:
        if "ffn_gate" in blk:
            blk["ffn_gate"] = np.full_like(blk["ffn_gate"], 0.5)
            blk["attn"]["gate"] = np.full_like(blk["attn"]["gate"], -0.7)
    return cfg, jcfg, tree, lm_params_from_numpy(cfg, tree, "cpu")


def _batches(cfg, jcfg, b, t, seed):
    return (make_batch(cfg, "prefill_32k", b, t, seed=seed),
            jax_make_batch(jcfg, "prefill_32k", b, t, seed=seed))


def _jax_grow(jcfg, cache, b, max_len):
    full = jax_init_cache(jcfg, b, max_len)
    return jax.tree.map(
        lambda d, s: s if d.shape == s.shape
        else d.at[tuple(slice(0, n) for n in s.shape)].set(s), full, cache)


def _port_steps(cfg, net, batch, b, max_len, n_dec):
    """Prefill + ``n_dec`` greedy steps; every step's last logits and the
    tokens picked."""
    logits, cache = make_prefill_step(cfg)(net, batch)
    cache = serve.graft(cfg, cache, b, max_len, "cpu")
    outs, toks = [_np(logits)], []
    decode = make_decode_step(cfg)
    for _ in range(n_dec):
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok.numpy())
        logits, cache = decode(net, cache, {"tokens": tok})
        outs.append(_np(logits))
    return outs, np.concatenate(toks, 1)


def _jax_steps(jcfg, tree, jbatch, b, max_len, n_dec):
    logits, cache = jax.jit(jax_make_prefill_step(jcfg))(tree, jbatch)
    cache = _jax_grow(jcfg, cache, b, max_len)
    decode = jax.jit(jax_make_decode_step(jcfg))
    outs, toks = [_np(logits)], []
    for _ in range(n_dec):
        tok = np.asarray(jnp.argmax(logits[:, -1], -1), np.int32)[:, None]
        toks.append(tok)
        logits, cache = decode(tree, cache, {"tokens": jnp.asarray(tok)})
        outs.append(_np(logits))
    return outs, np.concatenate(toks, 1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_f32_matches_reference(arch):
    cfg, jcfg, tree, net = _family(arch, "float32", seed=1)
    b, t, n_dec = 2, 16, 8
    max_len = t + n_dec + 1
    batch, jbatch = _batches(cfg, jcfg, b, t, seed=2)
    assert sorted(batch) == sorted(jbatch)
    ours, toks = _port_steps(cfg, net, batch, b, max_len, n_dec)
    ref, jtoks = _jax_steps(jcfg, tree, jbatch, b, max_len, n_dec)
    np.testing.assert_array_equal(toks, jtoks)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape == (b, 1, cfg.vocab)
        np.testing.assert_allclose(o, r, rtol=0,
                                   atol=1e-4 * float(np.abs(r).max()))
    # both packages' serving entry points pick the same tokens
    gen, _, record = serve.greedy_generate(cfg, net, batch, max_len, n_dec)
    jgen, _ = jax_greedy_generate(jcfg, tree, jbatch, max_len, n_dec)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    np.testing.assert_array_equal(gen.numpy()[:, 1:], toks[:, 1:n_dec])
    assert sum(record["launches"]["prefill"].values()) == 0      # CPU


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_teacher_forced_forward(arch):
    """bf16: the last prefill logits equal the training forward's at the
    same position (``tests/test_lm_archs.py``)."""
    cfg = smoke_config(arch)
    net = init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, "prefill_32k", 1, 16, seed=1)
    logits_pf, _ = make_prefill_step(cfg)(net, batch)
    kw = {k: batch[k] for k in ("tokens", "embeds", "cross_states")
          if k in batch}
    with torch.no_grad():
        ref, _ = forward(net, cfg, mode="train", **kw)
    a, r = _np(logits_pf[:, -1]), _np(ref[:, -1])
    if cfg.moe is not None:
        assert np.isclose(a, r, atol=2e-2, rtol=1e-2).mean() > 0.95
        np.testing.assert_array_equal(a.argmax(-1), r.argmax(-1))
    else:
        np.testing.assert_allclose(a, r, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_layout_equals_reference(arch):
    """Each layer's cache has the reference's names, shapes and dtypes
    (mLSTM's and sLSTM's states f32, ``m`` at -1e30)."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    ours = init_cache(cfg, 2, 24, device="cpu")
    ref = jax_init_cache(jcfg, 2, 24)
    assert ours["len"] == 0 and len(ours["layers"]) == cfg.n_layers
    plan = cfg.layer_plan()
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    for i, c in enumerate(ours["layers"]):
        if i < n_pre:
            rc = ref["prefix"][i]
        elif i - n_pre < cfg.repeats * n_pat:
            r, j = divmod(i - n_pre, n_pat)
            rc = jax.tree.map(lambda a: a[r], ref["blocks"][j])
        else:
            rc = ref["suffix"][i - n_pre - cfg.repeats * n_pat]
        assert sorted(c) == sorted(rc), (plan[i], sorted(c))
        for k, v in rc.items():
            assert tuple(c[k].shape) == v.shape, (plan[i], k)
            assert str(c[k].dtype).split(".")[-1] == str(v.dtype), \
                (plan[i], k, c[k].dtype, v.dtype)
            np.testing.assert_array_equal(_np(c[k]), _np(v))


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "16", "--gen", "3", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"arch", "batch", "gen", "prefill_s", "decode_s",
                           "tok_per_s"}
    assert report["arch"] == f"{arch}-smoke"
    assert tuple(out["tokens"].shape) == (2, 3)
    for lg in out["logits"].values():
        assert np.isfinite(_np(lg)).all()


@pytest.mark.parametrize("arch", ["musicgen-medium", "llama-3.2-vision-11b"])
def test_profile_serve_on_cpu(arch, capsys):
    """The profiling script serves the embedding-input and cross-attention
    archs too (its prompt holds ``embeds`` / ``cross_states``)."""
    res = profile_serve.main(["--arch", arch, "--smoke", "--batch", "2",
                              "--prompt-len", "8", "--gen", "2",
                              "--decode-steps", "2", "--device", "cpu"])
    assert set(res) == {"prefill", "decode"} and res["decode"]["steps"] == 2
    assert all(r["device_ms"] == 0 for r in res.values())



def test_profile_lm_on_cpu(capsys):
    """The A/B timing script serves and trains one architecture and
    reports the package it loaded (on the CPU: no device memory)."""
    from repro_torch.launch import profile_lm
    res = profile_lm.main(["--arch", "recurrentgemma-9b", "--smoke",
                           "--batch", "2", "--prompt-len", "16", "--gen",
                           "2", "--reps", "2", "--train-batch", "2",
                           "--seq", "16", "--microbatches", "1", "--steps",
                           "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["package"].endswith(
        "repro_torch/__init__.py")
    assert len(res["prefill_s"]) == 2 and len(res["step_s"]) == 2
    assert res["peak_gib"] is None
