"""The port's token pipeline and int8 KV codec against the reference
(``repro.data.tokens``, ``repro.models.lm.kv_quant``), and the cases of
``tests/test_data_kvquant.py`` run on the port.

Tolerances: batches, codes and scales bit-identical (both packages run the
same numpy, and the same f32 division and round-half-to-even); the
dequantised round trip within half a scale step; attention over an int8
cache within 3 % of the exact one, as the reference's own test holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import given, settings, st

from repro.data.tokens import TokenStream as JaxTokenStream
from repro.models.lm import kv_quant as jax_kvq
from repro_torch.data import TokenStream
from repro_torch.models.lm import kv_quant
from repro_torch.models.lm.attention import decode_attention


# ------------------------------------------------------------ TokenStream

@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), step=st.integers(0, 10 ** 6),
       n_shards=st.sampled_from([1, 2, 4, 8]), skew=st.sampled_from([1.0,
                                                                      1.2,
                                                                      1.5]))
def test_tokenstream_bit_identical_to_reference(seed, step, n_shards, skew):
    kw = dict(vocab=50304, seq_len=24, global_batch=8, seed=seed,
              n_shards=n_shards, skew=skew)
    for shard in range(n_shards):
        ours = TokenStream(shard=shard, **kw).batch(step)
        ref = JaxTokenStream(shard=shard, **kw).batch(step)
        assert sorted(ours) == sorted(ref) == ["targets", "tokens"]
        for k in ref:
            assert ours[k].dtype == ref[k].dtype == np.int32
            np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_array_equal(
        TokenStream(**kw).global_batch_at(step)["tokens"],
        JaxTokenStream(**kw).global_batch_at(step)["tokens"])


def test_tokenstream_deterministic():
    ts = TokenStream(vocab=1000, seq_len=32, global_batch=8, seed=7)
    assert np.array_equal(ts.batch(5)["tokens"], ts.batch(5)["tokens"])
    assert not np.array_equal(ts.batch(5)["tokens"], ts.batch(6)["tokens"])


def test_tokenstream_targets_shifted():
    b = TokenStream(vocab=1000, seq_len=16, global_batch=4).batch(0)
    assert np.array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert b["tokens"].shape == b["targets"].shape == (4, 16)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("step", [0, 17])
def test_tokenstream_shard_invariance(n_shards, step):
    """The global sample sequence is the same at any data-parallel
    degree (elasticity)."""
    ref = TokenStream(vocab=512, seq_len=8, global_batch=8, seed=3)
    sharded = TokenStream(vocab=512, seq_len=8, global_batch=8, seed=3,
                          n_shards=n_shards)
    assert np.array_equal(ref.batch(step)["tokens"],
                          sharded.global_batch_at(step)["tokens"])
    assert sharded.local_batch == 8 // n_shards


def test_tokenstream_vocab_bounds_and_skew():
    t = TokenStream(vocab=256, seq_len=64, global_batch=32,
                    skew=1.5).batch(0)["tokens"]
    assert t.min() >= 0 and t.max() < 256
    assert (t < 128).mean() > 0.55      # skew > 1 favours small ids


@pytest.mark.parametrize("kw", [dict(global_batch=6, n_shards=4),
                                dict(global_batch=8, n_shards=2, shard=2)])
def test_tokenstream_refuses_bad_sharding(kw):
    with pytest.raises(ValueError):
        TokenStream(vocab=10, seq_len=4, **kw)


# ------------------------------------------------------------ kv_quant

@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_identical_to_reference(scale, dtype):
    rng = np.random.default_rng(int(scale * 10) + len(dtype))
    x = (rng.standard_normal((2, 16, 4, 32)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                        # a zero row: the 1e-8 floor
    x[1, 2, 3, :4] = [127.0, -127.0, 63.5, 0.5]  # halves: round to even
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    codes, sc = kv_quant.quantize_kv(tx)
    jcodes, jsc = jax_kvq.quantize_kv(jx)
    assert codes.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        ours = kv_quant.dequantize_kv(codes, sc, dt)
        ref = jax_kvq.dequantize_kv(jcodes, jsc, jdt)
        assert ours.dtype == dt
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_kv_quant_roundtrip_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 4, 32)).astype(
        np.float32))
    codes, scale = kv_quant.quantize_kv(x)
    err = (kv_quant.dequantize_kv(codes, scale, torch.float32) - x).abs()
    assert bool((err <= scale[..., None] / 2 + 1e-6).all())


def test_kv_quant_attention_quality():
    """Attention over an int8 cache stays within 3 % of the exact one."""
    rng = np.random.default_rng(1)
    b, s, nkv, hd = 2, 64, 2, 32
    k, v = (torch.from_numpy(rng.standard_normal((b, s, nkv, hd)).astype(
        np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((b, 1, 4, hd)).astype(
        np.float32))
    pos = torch.arange(s, dtype=torch.int32)
    exact = decode_attention(q, k, v, pos, s - 1)
    kq, vq = (kv_quant.dequantize_kv(*kv_quant.quantize_kv(x), torch.float32)
              for x in (k, v))
    approx = decode_attention(q, kq, vq, pos, s - 1)
    assert float((approx - exact).norm() / exact.norm()) < 0.03


@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_bytes_ratio_equals_reference(hd, dtype):
    ours = kv_quant.cache_bytes_ratio(getattr(torch, dtype), hd)
    assert ours == jax_kvq.cache_bytes_ratio(getattr(jnp, dtype), hd)
    if (hd, dtype) == (128, "bfloat16"):
        assert 0.5 < ours < 0.55
