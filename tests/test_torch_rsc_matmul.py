"""The port's sampled weight gradient against the reference: the plain
version of ``gather_matmul``, block selection, ``sampled_xt_g`` and
``rsc_matmul`` (forward, dx, dW) against ``repro.core.rsc_matmul`` and
``jax.grad``.

Inputs are made by numpy from a seed and handed to both packages.
Tolerances: f32 at rtol 1e-5 / atol 1e-5·max|ref| (the two sum the same
f32 products in different orders); bf16 compared in f32 at rtol 1e-2 and
atol 1e-2·max|ref| (both round one f32 sum to bf16, so the order can flip
the last of its 8 bits); the reference's Pallas kernel in interpret mode at
its own test's tolerance (``tests/test_kernels.py``: atol 1e-4 in f32,
2e-1 in bf16, rtol 2e-2). Selected blocks must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rsc_matmul import _block_norms as jax_block_norms
from repro.core.rsc_matmul import rsc_matmul as jax_rsc_matmul
from repro.core.rsc_matmul import sampled_xt_g as jax_sampled_xt_g
from repro.kernels.ref import gather_matmul_ref as jax_gather_matmul_ref
from repro_torch.core import rsc_matmul as rsc
from repro_torch.kernels import gather_matmul as gmod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_matmul_ref

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# tests/test_kernels.py's gather_matmul sweep, plus a full-width-like block
SWEEP = [(64, 16, 24, 8, 3), (128, 32, 8, 16, 5), (64, 8, 8, 8, 8),
         (256, 40, 24, 32, 4)]


def _pair(a: np.ndarray, dtype: str):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a, jd)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, dtype: str) -> None:
    a, r = _np(ours), _np(ref)
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(a, r, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(r).max())))


def _operands(n, m, q, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, m)).astype(np.float32),
            rng.standard_normal((n, q)).astype(np.float32))


@pytest.mark.parametrize("n,m,q,bk,k_sel", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_matmul_plain_version(n, m, q, bk, k_sel, dtype):
    """The plain version (and the wrapper on a CPU tensor, which runs it
    without a launch) against the reference's oracle."""
    x, g = _operands(n, m, q, n + m + q)
    idx = np.sort(np.random.default_rng(bk).choice(n // bk, k_sel,
                                                   replace=False))
    (tx, jx), (tg, jg) = _pair(x, dtype), _pair(g, dtype)
    tidx = torch.from_numpy(idx.astype(np.int32))
    ref = jax_gather_matmul_ref(jx, jg, jnp.asarray(idx, jnp.int32), bk=bk)
    ours = gather_matmul_ref(tx, tg, tidx, bk=bk)
    assert ours.dtype == tx.dtype and ours.shape == (m, q)
    _close(ours, ref, dtype)
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.gather_matmul(tx, tg, tidx, bk=bk), ours,
                               rtol=0, atol=0)
    assert ops.launch_counts()["gather_matmul"] == 0


@pytest.mark.parametrize("case", ["negative", "past_end", "bk", "dtype",
                                  "shape"])
def test_gather_matmul_refuses_bad_inputs(case):
    x, g = (torch.from_numpy(a) for a in _operands(64, 8, 8, 0))
    idx = torch.tensor([0, 3], dtype=torch.int32)
    kw = dict(bk=16)
    if case == "negative":
        idx[0] = -1
    elif case == "past_end":
        idx[1] = 4
    elif case == "bk":
        kw["bk"] = 24
    elif case == "dtype":
        idx = idx.long()
    elif case == "shape":
        g = g[:32]
    with pytest.raises(ValueError):
        gmod.gather_matmul(x, g, idx, **kw)


@pytest.mark.parametrize("n,m,q,bk,keep", [(256, 24, 16, 32, 3),
                                           (512, 16, 40, 64, 4),
                                           (128, 8, 8, 8, 16)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sampled_xt_g_matches_reference(n, m, q, bk, keep, dtype):
    """Selected blocks equal jax.lax.top_k's; the output equals the
    reference's Pallas kernel (interpret mode) and its jnp path."""
    x, g = _operands(n, m, q, n + keep)
    (tx, jx), (tg, jg) = _pair(x, dtype), _pair(g, dtype)
    scores = jax_block_norms(jx, bk) * jax_block_norms(jg, bk)
    want = np.sort(np.asarray(jax.lax.top_k(scores, keep)[1]))
    got = rsc.select_blocks(tx, tg, keep, bk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(_np(rsc._block_norms(tx, bk)), _np(
        jax_block_norms(jx, bk)), rtol=1e-6)

    pallas = jax_sampled_xt_g(jx, jg, keep, bk, backend="pallas_interpret")
    plain = jax_sampled_xt_g(jx, jg, keep, bk, backend="jnp")
    for backend in ("kernel", "ref"):
        ours = rsc.sampled_xt_g(tx, tg, keep, bk, backend=backend)
        assert ours.dtype == tx.dtype and ours.shape == (m, q)
        _close(ours, plain, dtype)
        np.testing.assert_allclose(
            _np(ours), _np(pallas), rtol=2e-2,
            atol=1e-4 if dtype == "f32" else 2e-1)


@pytest.mark.parametrize("call", ["rsc_matmul", "sampled_xt_g"])
def test_ref_backend_refuses_tensors_off_the_cpu(call):
    """Backend ``"ref"`` takes CPU tensors only (on the card the kernel
    runs or the call raises); an unknown backend raises too."""
    x, w = torch.empty(64, 8, device="meta"), torch.empty(8, 4, device="meta")
    g = torch.empty(64, 4, device="meta")
    for backend in ("ref", "pallas"):
        with pytest.raises(ValueError):
            if call == "rsc_matmul":
                rsc.rsc_matmul(x, w, 0.5, 16, backend=backend)
            else:
                rsc.sampled_xt_g(x, g, 2, 16, backend=backend)


def test_selection_breaks_ties_like_top_k():
    """Equal scores: the lower block ids win, as in jax.lax.top_k."""
    x = torch.ones(64, 4)
    g = torch.ones(64, 3)
    x[48:] = 2.0    # block 3 strictly first, then blocks 0..2 tie
    np.testing.assert_array_equal(rsc.select_blocks(x, g, 3, 16).numpy(),
                                  [0, 1, 3])
    scores = jax_block_norms(jnp.asarray(x.numpy()), 16) * \
        jax_block_norms(jnp.asarray(g.numpy()), 16)
    assert sorted(np.asarray(jax.lax.top_k(scores, 3)[1])) == [0, 1, 3]


def _grads(x, w, g, keep_frac, bk):
    """(y, dx, dw) of ``sum(y * g)`` for y = rsc_matmul(x, w) in both
    packages."""
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = rsc.rsc_matmul(tx, tw, keep_frac, bk)
    dx, dw = torch.autograd.grad((y * torch.from_numpy(g)).sum(), (tx, tw))

    def f(xx, ww):
        return jnp.sum(jax_rsc_matmul(xx, ww, keep_frac, bk)
                       * jnp.asarray(g))
    jy = jax_rsc_matmul(jnp.asarray(x), jnp.asarray(w), keep_frac, bk)
    jdx, jdw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return (y, dx, dw), (jy, jdx, jdw)


@pytest.mark.parametrize("shape,keep_frac,bk", [
    ((256, 24), 0.5, 32), ((2, 96, 24), 0.25, 32), ((256, 24), 1.0, 64),
    ((2, 100, 24), 0.5, 32),      # 200 tokens: ragged, exact dW
    ((320, 24), 0.3, 64),         # keep = round(1.5) = 2 (half to even)
    ((64, 24), 0.1, 32),          # keep = round(0.2) = 0 -> at least 1
])
def test_rsc_matmul_forward_and_grads_match_reference(shape, keep_frac, bk):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((shape[-1], 16)).astype(np.float32)
    g = rng.standard_normal(shape[:-1] + (16,)).astype(np.float32)
    ours, ref = _grads(x, w, g, keep_frac, bk)
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape
        _close(o, r, "f32")


@pytest.mark.parametrize("n,keep_frac,bk,want", [
    (320, 0.3, 64, 2), (192, 0.5, 64, 2), (64, 0.1, 32, 1),
    (128, 2.0, 32, 4), (100, 0.5, 128, 1)])
def test_keep_count_rounds_like_the_reference(n, keep_frac, bk, want):
    assert rsc.keep_count(n, keep_frac, bk) == want


def test_rsc_matmul_full_keep_exact():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((256, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 16)).astype(
        np.float32)).requires_grad_()
    gw, = torch.autograd.grad((rsc.rsc_matmul(x, w, 1.0, 64) ** 2).sum(), w)
    gw_ref, = torch.autograd.grad(((x @ w) ** 2).sum(), w)
    torch.testing.assert_close(gw, gw_ref, rtol=1e-5, atol=1e-3)


def test_rsc_matmul_dx_always_exact():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((256, 24)).astype(
        np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    gx, = torch.autograd.grad((rsc.rsc_matmul(x, w, 0.25, 64) ** 2).sum(), x)
    gx_ref, = torch.autograd.grad(((x @ w) ** 2).sum(), x)
    torch.testing.assert_close(gx, gx_ref, rtol=1e-5, atol=1e-3)


def test_rsc_matmul_keeps_topk_blocks():
    """dW under keep_frac=0.5 is the contraction over the highest-norm
    half of the token blocks."""
    rng = np.random.default_rng(2)
    x = np.zeros((256, 8), np.float32)
    x[:64] = 10 * rng.standard_normal((64, 8))      # blocks 0-1 dominate
    x[64:] = 0.01 * rng.standard_normal((192, 8))
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(
        np.float32)).requires_grad_()
    gw, = torch.autograd.grad(
        (rsc.rsc_matmul(torch.from_numpy(x), w, 0.5, 64) ** 2).sum(), w)
    g = 2 * (x @ w.detach().numpy())
    np.testing.assert_allclose(gw.numpy(), x[:128].T @ g[:128], rtol=1e-5,
                               atol=1e-2)


def test_rsc_matmul_bf16_dtypes():
    """dx takes x's dtype and dW w's; the sampled dW equals the reference's
    in bf16."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 12))).astype(np.float32)
    g = rng.standard_normal((2, 64, 12)).astype(np.float32)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    y = rsc.rsc_matmul(tx, tw, 0.5, 32)
    dx, dw = torch.autograd.grad(y, (tx, tw),
                                 torch.from_numpy(g).bfloat16())
    assert dx.dtype == dw.dtype == torch.bfloat16
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: jax_rsc_matmul(a, b, 0.5, 32), jx, jw)
    jdx, jdw = vjp(jnp.asarray(g, jnp.bfloat16))
    _close(dx, jdx, "bf16")
    _close(dw, jdw, "bf16")


def test_rsc_matmul_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        rsc.rsc_matmul(torch.zeros(4, 3), torch.zeros(3, 2), 0.5, 2, "jnp")
