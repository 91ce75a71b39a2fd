"""The port's block-COO SpMM against the reference.

On the CPU the kernel wrapper runs its plain version (``bcoo_spmm_ref`` +
the fused epilogue); it is held against the Pallas kernel run in interpret
mode and against the reference's ``spmm_apply(backend="jnp")``. The CUDA
kernel itself is tested on the card by ``test_torch_kernels_cuda.py``.

Tolerances: f32 at rtol 1e-4 and atol 1e-4·max|ref| — both sides sum the
same f32 products in different orders. bf16 outputs are compared in f32
at rtol 1e-2 and atol 1e-3·max|ref|: both round f32 sums once to 8
significant bits, so a different summation order can flip the last bit
(2^-7 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import SamplePlan as JaxSamplePlan
from repro.core.rsc_spmm import spmm_apply as jax_spmm_apply
from repro.kernels.autotune import default_config as jax_default_config
from repro.kernels.bcoo_spmm import bcoo_spmm as jax_bcoo_spmm
from repro.kernels.ref import bcoo_spmm_ref as jax_bcoo_spmm_ref
from repro_torch.core.plan import SamplePlan
from repro_torch.core.rsc_spmm import exact_plan, spmm_apply, spmm_stream
from repro_torch.kernels import bcoo_spmm as kmod
from repro_torch.kernels import build, ops
from repro_torch.kernels.ref import bcoo_spmm_ref
from repro_torch.sparse.bcoo import HostBlockCOO, host_row_ptr

EPILOGUES = [(False, False, False), (True, False, False),
             (False, True, True), (True, True, True)]


def _tol(dtype, ref):
    scale = float(np.abs(ref).max()) if ref.size else 1.0
    if dtype == "bf16":
        return dict(rtol=1e-2, atol=1e-3 * max(scale, 1.0))
    return dict(rtol=1e-4, atol=1e-4 * max(scale, 1.0))


def _structure(rng, n_rb, n_cb, n_tiles, bm, bk, pad=3, empty=(1,)):
    """Random operand with the contract's corner cases: row blocks in
    ``empty`` have no entry at all (empty segments), a sentinel entry
    inside a segment, and ``pad`` sentinel pad entries on the last row."""
    pairs = set()
    while len(pairs) < n_tiles:
        r = int(rng.integers(0, n_rb))
        if r not in empty:
            pairs.add((r, int(rng.integers(0, n_cb))))
    entries = sorted(pairs)
    s = len(entries)
    blocks = np.concatenate([rng.standard_normal((s, bm, bk)),
                             np.zeros((1, bm, bk))]).astype(np.float32)
    rows = [e[0] for e in entries]
    cols = [e[1] for e in entries]
    sel = list(range(s))
    # a sentinel inside the first segment
    sel.insert(1, s)
    rows.insert(1, rows[0])
    cols.insert(1, 0)
    sel += [s] * pad
    rows += [rows[-1]] * pad
    cols += [0] * pad
    return (blocks, np.asarray(sel, np.int32), np.asarray(rows, np.int32),
            np.asarray(cols, np.int32))


def _operands(seed, bm, bk, d, n_rb=4, n_cb=5, n_tiles=9):
    rng = np.random.default_rng(seed)
    blocks, sel, rows, cols = _structure(rng, n_rb, n_cb, n_tiles, bm, bk)
    h = rng.standard_normal((n_cb * bk, d)).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    res = rng.standard_normal((n_rb * bm, d)).astype(np.float32)
    return blocks, sel, rows, cols, h, bias, res, n_rb


def _t(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bf16" and x.dtype == np.float32 \
        else t


def _j(x, dtype):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if dtype == "bf16" and x.dtype == \
        np.float32 else a


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("bm,bk,d,bd", [(8, 8, 16, 8), (16, 8, 41, 41),
                                        (8, 16, 24, 8), (32, 32, 40, 20)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias_on,res_on,relu", EPILOGUES)
def test_plain_kernel_matches_pallas_interpret(bm, bk, d, bd, dtype,
                                               bias_on, res_on, relu):
    """The wrapper on CPU tensors (the plain version) == the Pallas kernel
    in interpret mode, epilogue included, over empty segments, sentinel
    entries and padding."""
    blocks, sel, rows, cols, h, bias, res, n_rb = _operands(
        bm * 100 + bk + d, bm, bk, d)
    rptr = host_row_ptr(rows, n_rb)
    kw = dict(n_row_blocks=n_rb, bm=bm, bk=bk, bd=bd, relu=relu)
    ours = ops.bcoo_spmm(
        _t(blocks, dtype), _t(sel, dtype), _t(rows, dtype), _t(cols, dtype),
        _t(h, dtype), row_ptr=torch.from_numpy(rptr),
        bias=_t(bias, dtype) if bias_on else None,
        residual=_t(res, dtype) if res_on else None, **kw)
    ref = jax_bcoo_spmm(
        _j(blocks, dtype), _j(sel, dtype), _j(rows, dtype), _j(cols, dtype),
        _j(h, dtype), row_ptr=jnp.asarray(rptr),
        bias=_j(bias, dtype) if bias_on else None,
        residual=_j(res, dtype) if res_on else None, interpret=True, **kw)
    assert ours.dtype == (torch.bfloat16 if dtype == "bf16"
                          else torch.float32)
    assert tuple(ours.shape) == (n_rb * bm, d)
    ref = _np(ref)
    np.testing.assert_allclose(_np(ours), ref, **_tol(dtype, ref))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_row_ptr_none_is_recovered(dtype):
    blocks, sel, rows, cols, h, bias, _, n_rb = _operands(5, 8, 8, 16)
    kw = dict(n_row_blocks=n_rb, bm=8, bk=8, bd=16, relu=True)
    ours = ops.bcoo_spmm(_t(blocks, dtype), _t(sel, dtype), _t(rows, dtype),
                         _t(cols, dtype), _t(h, dtype),
                         bias=_t(bias, dtype), **kw)
    ref = _np(jax_bcoo_spmm(_j(blocks, dtype), _j(sel, dtype),
                            _j(rows, dtype), _j(cols, dtype), _j(h, dtype),
                            bias=_j(bias, dtype), interpret=True, **kw))
    np.testing.assert_allclose(_np(ours), ref, **_tol(dtype, ref))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bm,bk,d", [(8, 8, 16), (16, 8, 41)])
def test_ref_matches_reference_ref(bm, bk, d, dtype):
    blocks, sel, rows, cols, h, _, _, n_rb = _operands(11, bm, bk, d)
    kw = dict(n_row_blocks=n_rb, bm=bm, bk=bk)
    ours = bcoo_spmm_ref(_t(blocks, dtype), _t(sel, dtype), _t(rows, dtype),
                         _t(cols, dtype), _t(h, dtype), **kw)
    ref = _np(jax_bcoo_spmm_ref(_j(blocks, dtype), _j(sel, dtype),
                                _j(rows, dtype), _j(cols, dtype),
                                _j(h, dtype), **kw))
    np.testing.assert_allclose(_np(ours), ref, **_tol(dtype, ref))


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("chunk", [1, 4, 32])
@pytest.mark.parametrize("bias_on,res_on,relu", EPILOGUES)
def test_spmm_apply_matches_reference_jnp(backend, chunk, bias_on, res_on,
                                          relu):
    """``spmm_apply`` on both CPU backends == the reference's streaming
    ``spmm_apply(backend="jnp")`` with the same epilogue."""
    blocks, sel, rows, cols, h, bias, res, n_rb = _operands(
        chunk + 3, 16, 16, 24, n_rb=5, n_cb=4, n_tiles=10)
    rptr = host_row_ptr(rows, n_rb)
    n = sel.shape[0]
    plan = SamplePlan(sel=torch.from_numpy(sel),
                      row_ids=torch.from_numpy(rows),
                      col_ids=torch.from_numpy(cols), n_active=n, s_pad=n,
                      row_ptr=torch.from_numpy(rptr))
    jplan = JaxSamplePlan(sel=jnp.asarray(sel), row_ids=jnp.asarray(rows),
                          col_ids=jnp.asarray(cols), n_active=n, s_pad=n,
                          row_ptr=jnp.asarray(rptr))
    ours = spmm_apply(torch.from_numpy(blocks), plan, torch.from_numpy(h),
                      n_rb, 16, 16, backend,
                      bias=torch.from_numpy(bias) if bias_on else None,
                      residual=torch.from_numpy(res) if res_on else None,
                      relu=relu, chunk=chunk)
    ref = np.asarray(jax_spmm_apply(
        jnp.asarray(blocks), jplan, jnp.asarray(h), n_rb, 16, 16, "jnp",
        bias=jnp.asarray(bias) if bias_on else None,
        residual=jnp.asarray(res) if res_on else None, relu=relu,
        chunk=chunk))
    np.testing.assert_allclose(ours.numpy(), ref, **_tol("f32", ref))


def test_exact_plan_of_block_coo():
    rng = np.random.default_rng(0)
    blocks, _, rows, cols = _structure(rng, 4, 4, 7, 8, 8, pad=0, empty=())
    keep = np.ones(rows.shape[0], bool)
    keep[1] = False                    # drop the in-segment sentinel
    rows, cols = rows[keep], cols[keep]
    s = rows.shape[0]
    host = HostBlockCOO(blocks=blocks, row_ids=rows, col_ids=cols, bm=8,
                        bk=8, n_rows=32, n_cols=32, n_row_blocks=4,
                        n_col_blocks=4, s_total=s,
                        row_ptr=host_row_ptr(rows, 4))
    a = host.to_device("cpu")
    plan = exact_plan(a)
    assert plan.sel.dtype == torch.int32 and plan.s_pad == s
    h = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    out = spmm_apply(a.blocks, plan, h, 4, 8, 8, "kernel")
    dense = np.zeros((32, 32), np.float32)
    for t, (r, c) in enumerate(zip(rows, cols)):
        dense[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] += blocks[t]
    np.testing.assert_allclose(out.numpy(), dense @ h.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_empty_segment_is_epilogue_of_zero():
    """A row block with no entry comes out as relu(bias + residual)."""
    blocks, sel, rows, cols, h, bias, res, n_rb = _operands(3, 8, 8, 16)
    assert 1 not in rows
    out = ops.bcoo_spmm(*(torch.from_numpy(x) for x in
                          (blocks, sel, rows, cols, h)),
                        n_row_blocks=n_rb, bm=8, bk=8,
                        bias=torch.from_numpy(bias),
                        residual=torch.from_numpy(res), relu=True)
    want = np.maximum(bias[None, :] + res[8:16], 0.0)
    np.testing.assert_allclose(out[8:16].numpy(), want, rtol=1e-6)


def test_out_of_range_rows_are_dropped():
    """Entries on row ``n_row_blocks`` (the reference's scan padding) are
    dropped by the plain version and the streaming schedule alike."""
    blocks, sel, rows, cols, h, _, _, n_rb = _operands(4, 8, 8, 16)
    rows = rows.copy()
    rows[-3:] = n_rb
    sel = sel.copy()
    sel[-3:] = 0                      # a real tile: it must still drop
    kw = dict(n_row_blocks=n_rb, bm=8, bk=8)
    args = [torch.from_numpy(x) for x in (blocks, sel, rows, cols, h)]
    ref = np.asarray(jax_bcoo_spmm_ref(*(jnp.asarray(x) for x in
                                         (blocks, sel, rows, cols, h)),
                                       **kw))
    np.testing.assert_allclose(bcoo_spmm_ref(*args, **kw).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(spmm_stream(*args, chunk=4, **kw).numpy(),
                               ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 8, 41, 256, 512, 602, 1024])
def test_default_bd_matches_reference(d):
    assert ops.default_bd(d) == jax_default_config(d).bd
    assert ops.resolve_bd(None, d) == jax_default_config(d).bd


@pytest.mark.parametrize("bd,d,want", [(512, 602, 2), (128, 41, 41),
                                       (96, 256, 32), (256, 256, 256)])
def test_resolve_bd_gcd_fallback(bd, d, want):
    assert ops.resolve_bd(bd, d) == want


@pytest.mark.parametrize("case", ["dtype_mix", "bad_bd", "bad_blocks",
                                  "int64_ids", "bias_shape", "res_shape",
                                  "row_ptr_len"])
def test_wrapper_rejects_bad_inputs(case):
    blocks, sel, rows, cols, h, bias, res, n_rb = _operands(1, 8, 8, 16)
    args = dict(blocks=torch.from_numpy(blocks), sel=torch.from_numpy(sel),
                row_ids=torch.from_numpy(rows),
                col_ids=torch.from_numpy(cols), h=torch.from_numpy(h))
    kw = dict(n_row_blocks=n_rb, bm=8, bk=8, bd=8)
    if case == "dtype_mix":
        args["h"] = args["h"].to(torch.bfloat16)
    elif case == "bad_bd":
        kw["bd"] = 5
    elif case == "bad_blocks":
        kw["bm"] = 16
    elif case == "int64_ids":
        args["sel"] = args["sel"].long()
    elif case == "bias_shape":
        kw["bias"] = torch.zeros(15)
    elif case == "res_shape":
        kw["residual"] = torch.zeros(n_rb * 8 - 1, 16)
    elif case == "row_ptr_len":
        kw["row_ptr"] = torch.zeros(n_rb, dtype=torch.int32)
    with pytest.raises(ValueError):
        kmod.bcoo_spmm(*args.values(), **kw)


def test_non_cpu_tensors_never_take_the_plain_version():
    """On a tensor that is not on the CPU the wrapper launches the kernel
    or raises, and ``backend='ref'`` refuses: nothing drops to the plain
    version. (Meta tensors stand in for a device the kernel cannot take.)
    """
    blocks, sel, rows, cols, h, _, _, n_rb = _operands(2, 8, 8, 16)
    meta = [torch.from_numpy(x).to("meta") for x in
            (blocks, sel, rows, cols, h)]
    plan = SamplePlan(sel=meta[1], row_ids=meta[2], col_ids=meta[3],
                      n_active=sel.shape[0], s_pad=sel.shape[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmm_apply(meta[0], plan, meta[4], n_rb, 8, 8, "kernel")
    with pytest.raises(ValueError, match="CPU tensors only"):
        spmm_apply(meta[0], plan, meta[4], n_rb, 8, 8, "ref")
    with pytest.raises(ValueError, match="unknown SpMM backend"):
        spmm_apply(meta[0], plan, meta[4], n_rb, 8, 8, "pallas")


def test_plain_version_counts_no_launch():
    blocks, sel, rows, cols, h, _, _, n_rb = _operands(2, 8, 8, 16)
    ops.reset_launch_counts()
    ops.bcoo_spmm(*(torch.from_numpy(x) for x in
                    (blocks, sel, rows, cols, h)),
                  n_row_blocks=n_rb, bm=8, bk=8)
    assert ops.launch_counts() == {"bcoo_spmm": 0, "gather_matmul": 0,
                                   "flash_attention": 0}


def test_build_paths_and_missing_nvcc(monkeypatch, tmp_path):
    """The library lands in the git-ignored build directory under a name
    that changes with the source and flags; without nvcc the build
    raises instead of carrying on."""
    path = build.library_path("bcoo_spmm")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libbcoo_spmm-") and path.suffix == ".so"
    assert build.library_path("bcoo_spmm") == path
    root = build.BUILD_DIR.parents[1]
    assert "build/" in (root / ".gitignore").read_text().split()
    assert "-gencode" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
