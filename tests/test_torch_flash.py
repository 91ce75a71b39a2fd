"""The port's flash attention on the CPU: its plain version against the
reference's oracle and the Pallas kernel in interpret mode, and the
wrapper's CPU rules. The CUDA kernel itself is held against the same plain
version on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).

Tolerances are those of ``tests/test_kernels.py``'s flash sweep: f32 atol
2e-4, bf16 atol 5e-2, rtol 2e-2 (f32 softmax sums in another order; bf16
outputs rounded once on each side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels import flash_attention as kmod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

DTYPES = {"f32": (np.float32, torch.float32, 2e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}

# (b, tq, tk, nq, nkv, hd, window, q_offset): tests/test_kernels.py's
# shapes, then hd 64/128/256, GQA 14/2 and 16/1, q_offset and lengths that
# are not multiples of any block.
SHAPES = [
    (2, 32, 32, 4, 2, 16, None, 0), (1, 64, 64, 6, 1, 8, 16, 0),
    (2, 16, 16, 4, 4, 32, None, 0), (1, 32, 32, 8, 2, 8, 8, 0),
    (1, 24, 24, 4, 2, 64, None, 0), (1, 40, 40, 2, 1, 128, 16, 0),
    (2, 21, 21, 14, 2, 64, None, 0), (1, 37, 37, 14, 2, 16, 10, 0),
    (1, 8, 40, 4, 2, 16, None, 32), (2, 5, 33, 4, 1, 64, 9, 28),
    # hd 256 (recurrentgemma's local layers): GQA 16:1 and 4:1, windows
    (1, 40, 40, 16, 1, 256, 16, 0), (2, 24, 24, 4, 1, 256, None, 0),
    (1, 9, 48, 16, 1, 256, 20, 39),
]


def _inputs(seed, b, tq, tk, nq, nkv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, tq, nq, hd), (b, tk, nkv, hd), (b, tk, nkv, hd))]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(ours, ref, dtype):
    np.testing.assert_allclose(_np(ours), _np(ref), atol=DTYPES[dtype][2],
                               rtol=2e-2)


@pytest.mark.parametrize("b,tq,tk,nq,nkv,hd,window,q_offset", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_version_matches_reference_oracle_and_pallas(
        b, tq, tk, nq, nkv, hd, window, q_offset, dtype):
    (jq, jk, jv), (q, k, v) = _both(
        _inputs(tq + nq + hd, b, tq, tk, nq, nkv, hd), dtype)
    ours = flash_attention_ref(q, k, v, q_offset=q_offset, causal=True,
                               window=window)
    assert ours.dtype == q.dtype and ours.shape == q.shape
    _close(ours, jax_flash_ref(jq, jk, jv, q_offset=q_offset, causal=True,
                               window=window), dtype)
    blk = 8 if tq % 8 == 0 and tk % 8 == 0 else None
    pallas = flash_attention_fwd(jq, jk, jv, q_offset=q_offset, causal=True,
                                 window=window, bq=blk or tq, bk=blk or tk,
                                 interpret=True)
    _close(ours, pallas, dtype)


@pytest.mark.parametrize("causal,window,q_offset", [
    (False, None, 0), (False, 6, 0), (True, 4, 40), (True, None, -3),
    (False, 3, 30)])
def test_masks_and_fully_masked_rows(causal, window, q_offset):
    """Non-causal, windowed and shifted masks, including rows that see no
    key at all: those average every value, as the reference's -1e30 mask
    makes them."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(7, 2, 12, 20, 4, 2, 16), "f32")
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    ours = flash_attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(jax_flash_ref(jq, jk, jv, **kw)),
                               atol=1e-5, rtol=1e-5)
    if q_offset == 40:      # every row sees no key: the mean of v
        mean = v.mean(1, keepdim=True).repeat_interleave(2, dim=2)
        torch.testing.assert_close(ours, mean.expand_as(ours), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("q_chunk", [1, 5, 16, 100])
def test_query_chunks_do_not_change_the_result(q_chunk):
    _, (q, k, v) = _both(_inputs(3, 1, 16, 16, 4, 1, 8), "f32")
    whole = flash_attention_ref(q, k, v, window=5)
    torch.testing.assert_close(
        flash_attention_ref(q, k, v, window=5, q_chunk=q_chunk), whole,
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cpu_wrapper_runs_plain_version_without_a_launch(dtype):
    _, (q, k, v) = _both(_inputs(5, 2, 9, 9, 4, 2, 64), dtype)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, q_offset=0, causal=True, window=4)
    assert ops.launch_counts()["flash_attention"] == 0
    assert kmod.launches == 0
    torch.testing.assert_close(
        out, flash_attention_ref(q, k, v, causal=True, window=4),
        rtol=0, atol=0)


@pytest.mark.parametrize("case", ["nq_nkv", "dtype_mix", "kv_shape",
                                  "window", "empty_kv", "rank"])
def test_wrapper_refuses_bad_inputs_on_any_device(case):
    _, (q, k, v) = _both(_inputs(6, 1, 8, 8, 4, 2, 16), "f32")
    kw = {}
    if case == "nq_nkv":
        q = torch.zeros(1, 8, 3, 16)
    elif case == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif case == "kv_shape":
        v = v[:, :4]
    elif case == "window":
        kw["window"] = 0
    elif case == "empty_kv":
        k, v = k[:, :0], v[:, :0]
    elif case == "rank":
        q = q[0]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **kw)


def test_head_dims_include_256():
    """The kernel takes hd 256 (recurrentgemma-9b's local layers) on a
    variant of its own in bf16 and on ``fma`` in f32; an hd outside
    ``HEAD_DIMS`` is still refused by name."""
    assert 256 in kmod.HEAD_DIMS
    assert kmod.variant(torch.bfloat16, 256) == "wgmma_hd256"
    assert kmod.variant(torch.float32, 256) == "fma"
    for hd in (32, 96, 192, 512):
        with pytest.raises(ValueError, match="hd in"):
            kmod.variant(torch.bfloat16, hd)
