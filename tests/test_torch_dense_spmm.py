"""The port's dense SpMM backend (``kernels/dense_spmm.py`` and
``spmm_apply(..., "dense")``) against the reference's
``repro/kernels/dense_spmm.py`` on the same inputs, in the cases of
``tests/test_dense_backend.py``: density × keep fraction, every epilogue,
empty rows and duplicates, dropped padding rows, and gradients against the
streaming backend; then ``rsc_spmm`` / ``exact_spmm`` and a short training
run on the dense backend.

Tolerance: f32 at rtol 1e-5 and atol 1e-5·max|ref|, as the reference's
own dense tests hold it against ``segment_sum``: both sides compute one
f32 matmul (sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import build_plan as jax_build_plan
from repro.core.rsc_spmm import exact_plan as jax_exact_plan
from repro.core.rsc_spmm import exact_spmm as jax_exact_spmm
from repro.core.rsc_spmm import rsc_spmm as jax_rsc_spmm
from repro.core.rsc_spmm import spmm_apply as jax_spmm_apply
from repro.core.rsc_spmm import transpose_bcoo as jax_transpose_bcoo
from repro.kernels.dense_spmm import dense_lowering as jax_dense_lowering
from repro.kernels.dense_spmm import dense_spmm as jax_dense_spmm
from repro.sparse.bcoo import csr_to_bcoo as jax_csr_to_bcoo
from repro.sparse.topology import sym_normalize as jax_sym_normalize
from repro_torch.core.plan import build_plan
from repro_torch.core.rsc_spmm import (exact_plan, exact_spmm, rsc_spmm,
                                       spmm_apply, transpose_bcoo)
from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.kernels import ops
from repro_torch.kernels.dense_spmm import dense_lowering, dense_spmm
from repro_torch.kernels.ref import bcoo_spmm_ref
from repro_torch.sparse.bcoo import csr_to_bcoo
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.topology import sym_normalize
from repro_torch.train.loop import GNNTrainer, TrainConfig

from tests.conftest import random_csr
from tests.test_torch_gnn_train import one_torch_thread  # noqa: F401

TOL = 1e-5


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=TOL,
                               atol=TOL * scale)


def _csrs(n, density, seed):
    """``tests/conftest.py:random_csr`` as the port's and the reference's
    CSR."""
    jcsr = random_csr(n, density, seed=seed)
    return CSR(jcsr.rowptr, jcsr.col, jcsr.val, jcsr.shape), jcsr


def _plan_operands(n, density, seed, bm=8, keep_frac=None):
    """(port a, plan; reference a, plan): the full plan, or the first
    ``keep_frac`` of the column blocks, in buckets of 4."""
    csr, jcsr = _csrs(n, density, seed)
    a, meta = csr_to_bcoo(sym_normalize(csr), bm, bm, device="cpu")
    ja, jmeta = jax_csr_to_bcoo(jax_sym_normalize(jcsr), bm, bm)
    keep = None
    if keep_frac is not None:
        keep = np.zeros(a.n_col_blocks, bool)
        keep[: max(1, int(keep_frac * a.n_col_blocks))] = True
    plan = build_plan(meta, keep, a.n_row_blocks, a.s_total, bucket=4,
                      device="cpu")
    jplan = jax_build_plan(jmeta, keep, ja.n_row_blocks, ja.s_total,
                           bucket=4)
    return a, plan, ja, jplan


def _ids(plan):
    return plan.sel, plan.row_ids, plan.col_ids


# ------------------------------------------------------------ parity

@pytest.mark.parametrize("density,keep_frac", [
    (0.05, None), (0.05, 0.5), (0.2, None), (0.2, 0.25), (0.5, 0.8)])
def test_dense_matches_reference(density, keep_frac):
    a, plan, ja, jplan = _plan_operands(64, density, seed=1,
                                        keep_frac=keep_frac)
    h = np.random.default_rng(2).standard_normal((a.n_cols, 24)) \
        .astype(np.float32)
    kw = dict(n_row_blocks=a.n_row_blocks, bm=a.bm, bk=a.bk)
    ours = dense_spmm(a.blocks, *_ids(plan), torch.from_numpy(h), **kw)
    ref = jax_dense_spmm(ja.blocks, jplan.sel, jplan.row_ids, jplan.col_ids,
                         jnp.asarray(h), **kw)
    assert ours.dtype == torch.float32 and ours.shape == (a.n_rows, 24)
    _close(ours, ref)
    # and the port's own plain segment sum
    _close(ours, bcoo_spmm_ref(a.blocks, *_ids(plan), torch.from_numpy(h),
                               **kw))
    # the dense operand itself
    kw2 = dict(n_row_blocks=a.n_row_blocks, n_col_blocks=a.n_col_blocks,
               bm=a.bm, bk=a.bk)
    np.testing.assert_array_equal(
        dense_lowering(a.blocks, *_ids(plan), **kw2).numpy(),
        np.asarray(jax_dense_lowering(ja.blocks, jplan.sel, jplan.row_ids,
                                      jplan.col_ids, **kw2)))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_dense_epilogue_matches_reference(bias, residual, relu):
    a, plan, ja, jplan = _plan_operands(64, 0.15, seed=5)
    rng = np.random.default_rng(6)
    d = 16
    h = rng.standard_normal((a.n_cols, d)).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32) if bias else None
    r = rng.standard_normal((a.n_rows, d)).astype(np.float32) \
        if residual else None

    def t(x):
        return None if x is None else torch.from_numpy(x)

    def j(x):
        return None if x is None else jnp.asarray(x)

    ours = spmm_apply(a.blocks, plan, t(h), a.n_row_blocks, a.bm, a.bk,
                      "dense", bias=t(b), residual=t(r), relu=relu)
    ref = jax_spmm_apply(ja.blocks, jplan, j(h), ja.n_row_blocks, ja.bm,
                         ja.bk, "dense", bias=j(b), residual=j(r), relu=relu)
    _close(ours, ref)
    # the same contract as the kernel backend's
    _close(ours, spmm_apply(a.blocks, plan, t(h), a.n_row_blocks, a.bm,
                            a.bk, "kernel", bias=t(b), residual=t(r),
                            relu=relu))


def _tiny(bm, bk, n_tiles):
    """``n_tiles`` all-ones tiles and the zero sentinel."""
    return np.concatenate([np.ones((n_tiles, bm, bk), np.float32),
                           np.zeros((1, bm, bk), np.float32)])


def test_dense_empty_rows_and_duplicates():
    """Row blocks with no tiles come out exactly zero, and duplicate
    (row, col) tiles accumulate, on both packages."""
    bm = bk = 8
    blocks = _tiny(bm, bk, 2)
    sel = np.array([0, 1, 0], np.int32)
    rows = np.array([0, 3, 0], np.int32)   # rows 1, 2 empty; (0, 0) twice
    cols = np.array([0, 1, 0], np.int32)
    h = np.ones((2 * bk, 4), np.float32)
    ours = dense_spmm(*(torch.from_numpy(x) for x in
                        (blocks, sel, rows, cols, h)),
                      n_row_blocks=4, bm=bm, bk=bk).numpy()
    ref = np.asarray(jax_dense_spmm(*(jnp.asarray(x) for x in
                                      (blocks, sel, rows, cols, h)),
                                    n_row_blocks=4, bm=bm, bk=bk))
    np.testing.assert_array_equal(ours, ref)
    assert np.all(ours[:bm] == 2 * bk)           # duplicate accumulated
    assert np.all(ours[bm:3 * bm] == 0.0)        # empty rows exactly zero
    assert np.all(ours[3 * bm:] == bk)


def test_dense_lowering_drops_padding_rows():
    """Padding entries carry ``row_id == n_row_blocks``: dropped, not
    wrapped onto a real row."""
    bm = bk = 4
    blocks = _tiny(bm, bk, 1)
    sel = np.array([0, 0], np.int32)
    rows = np.array([0, 2], np.int32)      # the second is padding
    cols = np.array([0, 0], np.int32)
    kw = dict(n_row_blocks=2, n_col_blocks=1, bm=bm, bk=bk)
    ours = dense_lowering(*(torch.from_numpy(x) for x in
                            (blocks, sel, rows, cols)), **kw).numpy()
    ref = np.asarray(jax_dense_lowering(*(jnp.asarray(x) for x in
                                          (blocks, sel, rows, cols)), **kw))
    assert ours.shape == (2 * bm, bk)
    np.testing.assert_array_equal(ours, ref)
    assert np.all(ours[:bm] == 1.0) and np.all(ours[bm:] == 0.0)


def test_dense_spmm_rejects_ragged_h():
    bm = bk = 4
    with pytest.raises(ValueError, match="multiple of bk"):
        dense_spmm(torch.from_numpy(_tiny(bm, bk, 1)),
                   torch.zeros(1, dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32), torch.ones(6, 2),
                   n_row_blocks=1, bm=bm, bk=bk)


# ------------------------------------------------------------ gradients

def _grad_operands():
    csr, jcsr = _csrs(48, 0.2, seed=7)
    a, _ = csr_to_bcoo(sym_normalize(csr), 8, 8, device="cpu")
    ja, _ = jax_csr_to_bcoo(jax_sym_normalize(jcsr), 8, 8)
    rng = np.random.default_rng(8)
    d = 12
    h = rng.standard_normal((a.n_cols, d)).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    r = rng.standard_normal((a.n_rows, d)).astype(np.float32)
    return a, transpose_bcoo(a), ja, jax_transpose_bcoo(ja), h, b, r


def _torch_grads(fn, h, b, r):
    xs = [torch.from_numpy(x).requires_grad_() for x in (h, b, r)]
    torch.sum(fn(*xs) ** 2).backward()
    return [x.grad.numpy() for x in xs]


def test_dense_backend_gradients_match_stream():
    """``rsc_spmm``'s autograd wraps whichever backend runs: on the dense
    backend (fused epilogue, the exact backward plan) the gradients equal
    the streaming backend's and the reference's dense ones."""
    a, at, ja, jat, h, b, r = _grad_operands()
    plan = exact_plan(at)

    def ours(backend):
        return _torch_grads(lambda h_, b_, r_: rsc_spmm(
            a, at, plan, h_, backend, bias=b_, residual=r_, relu=True),
            h, b, r)

    def jloss(h_, b_, r_):
        return jnp.sum(jax_rsc_spmm(ja, jat, jax_exact_plan(jat), h_,
                                    "dense", bias=b_, residual=r_,
                                    relu=True) ** 2)

    gd, gs = ours("dense"), ours("ref")
    gj = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (h, b, r)))
    for x, y, z in zip(gd, gs, gj):
        _close(x, y)
        _close(x, z)


@pytest.mark.parametrize("relu", [False, True])
def test_dense_exact_spmm_matches_reference(relu):
    a, at, ja, jat, h, b, r = _grad_operands()
    ours = _torch_grads(lambda h_, b_, r_: exact_spmm(
        a, at, h_, "dense", bias=b_, residual=r_, relu=relu), h, b, r)

    def jloss(h_, b_, r_):
        return jnp.sum(jax_exact_spmm(ja, jat, h_, "dense", bias=b_,
                                      residual=r_, relu=relu) ** 2)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (h, b, r)))
    for x, y in zip(ours, ref):
        _close(x, y)


def test_dense_sampled_backward_matches_reference():
    """A sampled backward plan (half the column blocks, bucket padding) on
    the dense backend against the reference's dense backend."""
    csr, jcsr = _csrs(64, 0.15, seed=9)
    a, _ = csr_to_bcoo(sym_normalize(csr), 8, 8, device="cpu")
    at, at_meta = csr_to_bcoo(sym_normalize(csr).transpose(), 8, 8,
                              device="cpu")
    ja, _ = jax_csr_to_bcoo(jax_sym_normalize(jcsr), 8, 8)
    jat, jat_meta = jax_csr_to_bcoo(jax_sym_normalize(jcsr).transpose(), 8,
                                    8)
    keep = np.random.default_rng(10).random(at.n_col_blocks) < 0.5
    plan = build_plan(at_meta, keep, at.n_row_blocks, at.s_total, bucket=16,
                      device="cpu")
    jplan = jax_build_plan(jat_meta, keep, jat.n_row_blocks, jat.s_total,
                           bucket=16)
    rng = np.random.default_rng(11)
    h = rng.standard_normal((a.n_cols, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    r = rng.standard_normal((a.n_rows, 10)).astype(np.float32)
    ours = _torch_grads(lambda h_, b_, r_: rsc_spmm(
        a, at, plan, h_, "dense", bias=b_, residual=r_, relu=True), h, b, r)

    def jloss(h_, b_, r_):
        return jnp.sum(jax_rsc_spmm(ja, jat, jplan, h_, "dense", bias=b_,
                                    residual=r_, relu=True) ** 2)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (h, b, r)))
    for x, y in zip(ours, ref):
        _close(x, y)


# ------------------------------------------------------------ training

def test_dense_training_matches_kernel_backend():
    """A short GCN run with RSC on the dense backend against the kernel
    backend (its plain version here): the same plans at every step, losses
    within 1e-5, and no kernel launch counted."""
    g = sbm_graph(n_nodes=300, n_clusters=5, avg_degree=10, feat_dim=16,
                  seed=0)
    runs = {}
    for backend in ("kernel", "dense"):
        tr = GNNTrainer(TrainConfig(model="gcn", n_layers=2, hidden=24,
                                    block=32, dropout=0.0, rsc=True,
                                    budget=0.3, epochs=15, backend=backend,
                                    device="cpu"), g)
        seen = []
        plans_for = tr.engine.planner.plans_for

        def capture(tag, step, schedule, plans_for=plans_for, seen=seen):
            out = plans_for(tag, step, schedule)
            seen.append({k: p.sel.clone() for k, p in out.items()})
            return out

        tr.engine.planner.plans_for = capture
        ops.reset_launch_counts()
        runs[backend] = (tr.train(eval_every=5), seen)
        assert ops.launch_counts()["bcoo_spmm"] == 0
    (kres, kplans), (dres, dplans) = runs["kernel"], runs["dense"]
    assert kres["history"]["mode"] == dres["history"]["mode"]
    assert len(kplans) == len(dplans) == 12
    for x, y in zip(kplans, dplans):
        assert all(torch.equal(x[k], y[k]) for k in x)
    np.testing.assert_allclose(dres["history"]["loss"],
                               kres["history"]["loss"], rtol=TOL)
