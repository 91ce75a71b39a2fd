"""The port's ``rsc_spmm`` / ``exact_spmm`` (``torch.autograd.Function``s)
against ``jax.vjp`` of the reference's ``custom_vjp``s, and
``transpose_bcoo`` against the reference's.

Both port backends run: ``ref`` (the streaming schedule) and ``kernel``
(on the CPU the kernel wrapper's plain version, through the in-range
entry the training path uses). Cases: a full backward plan, a sampled
one (40 % of the column blocks, padded to a bucket of 16, so the last
row block carries sentinel padding and some rows only a sentinel), and
the exact op; with and without ReLU / bias / residual.

Tolerance: f32 at rtol 1e-4 and atol 1e-4·max|ref| (as in
``test_torch_spmm.py``): both sides sum the same f32 products in
different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import build_plan as jax_build_plan
from repro.core.rsc_spmm import exact_spmm as jax_exact_spmm
from repro.core.rsc_spmm import rsc_spmm as jax_rsc_spmm
from repro.core.rsc_spmm import transpose_bcoo as jax_transpose_bcoo
from repro.sparse.bcoo import csr_to_bcoo as jax_csr_to_bcoo
from repro.sparse.csr import CSR as JaxCSR
from repro_torch.core.plan import build_plan
from repro_torch.core.rsc_spmm import exact_spmm, rsc_spmm, transpose_bcoo
from repro_torch.kernels import ops
from repro_torch.sparse.bcoo import csr_to_bcoo
from repro_torch.sparse.csr import CSR

N, BLOCK, D = 120, 16, 12
EPILOGUES = [(False, False, False), (True, False, False),
             (False, True, True), (True, True, True)]  # (relu, bias, res)


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.fixture(scope="module")
def operands():
    """(port a, at, at_meta; reference a, at, at_meta) of a random
    non-symmetric 120×120 operand (8 row blocks, the last ragged)."""
    rng = np.random.default_rng(0)
    mask = rng.random((N, N)) < 0.08
    rows, cols = np.nonzero(mask)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    csr = CSR.from_coo(rows, cols, vals, (N, N))
    jcsr = JaxCSR.from_coo(rows, cols, vals, (N, N))
    a, _ = csr_to_bcoo(csr, BLOCK, BLOCK, device="cpu")
    at, at_meta = csr_to_bcoo(csr.transpose(), BLOCK, BLOCK, device="cpu")
    ja, _ = jax_csr_to_bcoo(jcsr, BLOCK, BLOCK)
    jat, jat_meta = jax_csr_to_bcoo(jcsr.transpose(), BLOCK, BLOCK)
    return a, at, at_meta, ja, jat, jat_meta


def _plans(at, at_meta, jat, jat_meta, sampled: bool):
    keep = None
    if sampled:
        keep = np.random.default_rng(1).random(at.n_col_blocks) < 0.4
    ours = build_plan(at_meta, keep, at.n_row_blocks, at.s_total,
                      bucket=16 if sampled else 1, device="cpu")
    ref = jax_build_plan(jat_meta, keep, jat.n_row_blocks, jat.s_total,
                         bucket=16 if sampled else 1)
    return ours, ref


def _inputs(a, seed=2):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((a.n_cols, D)).astype(np.float32)
    bias = rng.standard_normal(D).astype(np.float32)
    res = rng.standard_normal((a.n_rows, D)).astype(np.float32)
    g = rng.standard_normal((a.n_rows, D)).astype(np.float32)
    return h, bias, res, g


@pytest.mark.parametrize("relu,with_bias,with_res", EPILOGUES)
@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("op", ["rsc_full", "rsc_sampled", "exact"])
def test_forward_and_vjp_match_reference(operands, op, backend, relu,
                                         with_bias, with_res):
    a, at, at_meta, ja, jat, jat_meta = operands
    h, bias, res, g = _inputs(a)
    if op == "exact":
        def ours_fn(h_, b_, r_):
            return exact_spmm(a, at, h_, backend, bias=b_, residual=r_,
                              relu=relu)

        def ref_fn(h_, b_, r_):
            return jax_exact_spmm(ja, jat, h_, "jnp", bias=b_, residual=r_,
                                  relu=relu)
    else:
        plan, jplan = _plans(at, at_meta, jat, jat_meta,
                             sampled=op == "rsc_sampled")

        def ours_fn(h_, b_, r_):
            return rsc_spmm(a, at, plan, h_, backend, bias=b_, residual=r_,
                            relu=relu)

        def ref_fn(h_, b_, r_):
            return jax_rsc_spmm(ja, jat, jplan, h_, "jnp", bias=b_,
                                residual=r_, relu=relu)

    th = torch.from_numpy(h).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_() if with_bias else None
    tr = torch.from_numpy(res).requires_grad_() if with_res else None
    out = ours_fn(th, tb, tr)
    out.backward(torch.from_numpy(g))

    jb = jnp.asarray(bias) if with_bias else None
    jr = jnp.asarray(res) if with_res else None
    ref_out, vjp = jax.vjp(ref_fn, jnp.asarray(h), jb, jr)
    dh, db, dr = vjp(jnp.asarray(g))
    _close(out.detach(), ref_out)
    _close(th.grad, dh)
    if with_bias:
        _close(tb.grad, db)
    if with_res:
        _close(tr.grad, dr)


def test_sampled_backward_keeps_the_planned_pairs(operands):
    """The forward stays exact; ∇h under a plan keeping column blocks K of
    Ãᵀ is the exact ∇h of a cotangent whose rows outside K are zero (the
    kept column-row pairs, paper Eq. 2)."""
    a, at, at_meta, *_ = operands
    h, _, _, g = _inputs(a, seed=3)
    keep = np.zeros(at.n_col_blocks, bool)
    keep[::2] = True
    plan = build_plan(at_meta, keep, at.n_row_blocks, at.s_total,
                      device="cpu")
    kept_rows = torch.from_numpy(np.repeat(keep, BLOCK)[:, None])
    grads, outs = [], []
    for fn, cot in ((lambda x: rsc_spmm(a, at, plan, x), g),
                    (lambda x: exact_spmm(a, at, x), g),
                    (lambda x: exact_spmm(a, at, x),
                     np.where(kept_rows.numpy(), g, 0))):
        th = torch.from_numpy(h).requires_grad_()
        out = fn(th)
        out.backward(torch.from_numpy(np.ascontiguousarray(cot)))
        outs.append(out.detach())
        grads.append(th.grad)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    _close(grads[0], grads[2].numpy())
    assert not torch.allclose(grads[0], grads[1])


def test_relu_backward_mask_independence(operands):
    """Prop. 3.1's mechanism: the ReLU mask comes from the EXACT forward,
    so it is identical between exact and sampled backward paths (mirrors
    ``tests/test_rsc_ops.py``)."""
    a, at, at_meta, *_ = operands
    h = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (a.n_cols, 6)).astype(np.float32))
    keep = np.zeros(at.n_col_blocks, bool)
    keep[::2] = True
    plan = build_plan(at_meta, keep, at.n_row_blocks, at.s_total,
                      device="cpu")
    mask_rsc = torch.relu(rsc_spmm(a, at, plan, h)) > 0
    mask_ex = torch.relu(exact_spmm(a, at, h)) > 0
    assert torch.equal(mask_rsc, mask_ex)
    # and the fused ReLU's mask is the same one
    fused = rsc_spmm(a, at, plan, h, relu=True) > 0
    assert torch.equal(fused, mask_ex)


def test_transpose_bcoo_matches_reference(operands):
    a, at, _, ja, jat, _ = operands
    ours, ref = transpose_bcoo(a), jax_transpose_bcoo(ja)
    for f in ("blocks", "row_ids", "col_ids", "row_ptr"):
        assert np.array_equal(getattr(ours, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    for f in ("bm", "bk", "n_rows", "n_cols", "n_row_blocks",
              "n_col_blocks", "s_total"):
        assert getattr(ours, f) == getattr(ref, f), f
    # and it is the operand built from the transposed CSR
    for f in ("blocks", "row_ids", "col_ids", "row_ptr"):
        assert torch.equal(getattr(ours, f), getattr(at, f)), f


def test_in_range_entry_matches_checked_entry(operands):
    """On the CPU both entries run the plain version: same output."""
    a, at, at_meta, *_ = operands
    h, bias, res, _ = _inputs(a)
    plan = build_plan(at_meta, None, at.n_row_blocks, at.s_total,
                      device="cpu")
    kw = dict(n_row_blocks=at.n_row_blocks, bm=BLOCK, bk=BLOCK,
              row_ptr=plan.row_ptr, bias=torch.from_numpy(bias),
              residual=torch.from_numpy(res), relu=True)
    args = (at.blocks, plan.sel, plan.row_ids, plan.col_ids,
            torch.from_numpy(h))
    torch.testing.assert_close(ops.bcoo_spmm_in_range(*args, **kw),
                               ops.bcoo_spmm(*args, **kw), rtol=0, atol=0)
