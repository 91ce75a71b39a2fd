"""The port's LM families beyond the dense one in bf16 against the
reference: each smoke config's prefill + one decode step, and each layer
on its own, from the reference's parameters carried across by
``convert.lm_params_from_numpy``.

Tolerance: at least 95 % of logits (or of a layer's outputs) within atol
2e-2 / rtol 1e-2 and the same top-1, the rule of ``tests/test_lm_archs.py``.
The port evaluates the reference's graph of elementwise ops in bf16
(``models/lm/layers.py``: activations), so it rounds where the reference
rounds; most families then agree bit for bit.

The whole reference model runs op by op here (``jax.disable_jit``; each
layer on its own is jitted): under ``jit`` XLA may skip a cast to bf16
between two ops (it allows itself excess precision), which the
reference's op graph and the port both round at.
Through the 8-10 bf16 layers of a smoke config such one-unit differences
grow past the rule against the jitted reference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import make_batch as jax_make_batch
from repro.configs import smoke_config as jax_smoke_config
from repro.models.lm.backbone import init_cache as jax_init_cache
from repro.models.lm.backbone import init_params as jax_init_params
from repro.models.lm.backbone import layer_apply as jax_layer_apply
from repro.models.lm.layers import apply_norm as jax_apply_norm
from repro.train.lm_steps import make_decode_step as jax_make_decode_step
from repro.train.lm_steps import make_prefill_step as jax_make_prefill_step
from repro_torch.configs import make_batch, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.lm.backbone import layer_apply
from repro_torch.models.lm.layers import apply_norm
from repro_torch.train.lm_steps import make_decode_step, make_prefill_step

FAMILIES = ["xlstm-125m", "recurrentgemma-9b", "llama-3.2-vision-11b",
            "deepseek-v2-lite-16b", "deepseek-v2-236b", "musicgen-medium"]
# The whole-model rule holds for every family but xLSTM. There each layer
# agrees with the reference's from the same input
# (test_bf16_layers_match_reference), but a bf16 matrix product that
# rounds one element one unit the other way (the two packages accumulate
# in other orders) grows over the smoke config's 8 layers past the rule.
# xLSTM is held whole in f32 (tests/test_torch_lm_families.py).
BF16_WHOLE_MODEL = [a for a in FAMILIES if a != "xlstm-125m"]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _family(arch, seed=2):
    cfg = smoke_config(arch)
    jcfg = jax_smoke_config(arch)
    assert cfg.dtype == jcfg.dtype == "bfloat16"
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


@functools.lru_cache(maxsize=None)
def _jax_layer(jcfg, kind):
    """The reference's prefill of one layer of ``kind``, jitted (within one
    layer ``jit``'s excess precision stays far inside the rule)."""
    def run(p, h, pos, cross_states):
        return jax_layer_apply(p, jcfg, kind, h, pos, mode="prefill",
                               cross_states=cross_states)[0]
    return jax.jit(run)


def _rule(ours, ref):
    a, r = _np(ours)[:, -1], _np(ref)[:, -1]
    close = np.isclose(a, r, atol=2e-2, rtol=1e-2).mean()
    assert close > 0.95, close
    np.testing.assert_array_equal(a.argmax(-1), r.argmax(-1))


@pytest.mark.parametrize("arch", BF16_WHOLE_MODEL)
def test_prefill_decode_bf16_matches_reference(arch):
    cfg, jcfg, tree, net = _family(arch)
    b, t = 2, 16
    batch, jbatch = _batches(cfg, jcfg, b, t, seed=3)
    logits, cache = make_prefill_step(cfg)(net, batch)
    with jax.disable_jit():
        jlogits, jcache = jax_make_prefill_step(jcfg)(tree, jbatch)
        tok = np.asarray(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None]
        jcache = _jax_grow(jcfg, jcache, b, t + 2)
        jdec, _ = jax_make_decode_step(jcfg)(tree, jcache,
                                             {"tokens": jnp.asarray(tok)})
    cache = serve.graft(cfg, cache, b, t + 2, "cpu")
    dec, _ = make_decode_step(cfg)(net, cache,
                                   {"tokens": torch.from_numpy(tok.copy())})
    _rule(logits, jlogits)
    _rule(dec, jdec)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_layers_match_reference(arch):
    """bf16 prefill, layer by layer: each layer of the port fed the
    reference's input to that layer gives the reference's output within
    the 95 % rule (atol 2e-2 / rtol 1e-2), and the final norm and logits
    from the reference's last hidden state give its top-1."""
    cfg, jcfg, tree, net = _family(arch)
    batch, jbatch = _batches(cfg, jcfg, 2, 16, seed=3)
    if "embeds" in jbatch:
        jh = jnp.asarray(jbatch["embeds"]).astype(jnp.bfloat16)
    else:
        jh = jnp.take(tree["embed"], jbatch["tokens"], axis=0)
    pos, jpos = torch.arange(16, dtype=torch.int32), jnp.arange(16)
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    for i, kind in enumerate(cfg.layer_plan()):
        if i < n_pre:
            jp = tree["prefix"][i]
        elif i - n_pre < cfg.repeats * n_pat:
            r, j = divmod(i - n_pre, n_pat)
            jp = jax.tree.map(lambda a: a[r], tree["blocks"][j])
        else:
            jp = tree["suffix"][i - n_pre - cfg.repeats * n_pat]
        h_in = torch.from_numpy(_np(jh)).to(torch.bfloat16)
        with torch.no_grad():
            h, _ = layer_apply(net.layers[i], cfg, kind, h_in, pos,
                               mode="prefill",
                               cross_states=batch.get("cross_states"))
        jh = _jax_layer(jcfg, kind)(jp, jh, jpos, jbatch.get("cross_states"))
        close = np.isclose(_np(h), _np(jh), atol=2e-2, rtol=1e-2).mean()
        assert close > 0.95, (i, kind, close)
    with torch.no_grad():
        logits, _ = forward_head(net, cfg, torch.from_numpy(_np(jh)).to(
            torch.bfloat16))
    jn = jax_apply_norm(tree["final_norm"], jh, jcfg.norm_eps)
    jlogits = jn.astype(jnp.float32) @ tree["embed"].astype(jnp.float32).T \
        if jcfg.tie_embeddings else \
        (jn @ tree["unembed"]["w"]).astype(jnp.float32)
    _rule(logits, jlogits)


def forward_head(net, cfg, h):
    """The final norm and the logits of the last hidden state ``h``."""
    h = apply_norm(net.final_norm, h, cfg.norm_eps)
    if net.unembed is None:
        return h.float() @ net.embed.float().T, None
    return (h @ net.unembed.w).float(), None
