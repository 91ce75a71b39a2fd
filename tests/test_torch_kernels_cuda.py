"""The CUDA kernel of the port on the card: ``bcoo_spmm`` against its plain
PyTorch version, the wrapper's refusals, and the streaming forward on
``cuda`` against the same forward on the CPU.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor ``repro``, so it runs on a machine with only
PyTorch; from the repository root there:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: f32 at rtol 1e-4 and atol 1e-4·max|ref| (the kernel and the
plain version sum the same f32 products in different orders); bf16
compared in f32 at rtol 2e-2 and atol 1e-3·max|ref| (one f32 sum rounded
once to 8 significant bits on each side, so the order can flip the last
bit).
"""
import numpy as np
import pytest
import torch

from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.infer import StreamConfig, StreamingInference
from repro_torch.kernels import bcoo_spmm as kmod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import bcoo_spmm_ref
from repro_torch.models.gnn import gcn

pytestmark = pytest.mark.cuda

EPILOGUES = [(False, False, False), (True, False, False),
             (False, True, True), (True, True, True)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _close(out, ref, dtype):
    out, ref = out.float().cpu(), ref.float().cpu()
    scale = max(1.0, float(ref.abs().max()))
    rtol, atol = (2e-2, 1e-3) if dtype == "bf16" else (1e-4, 1e-4)
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol * scale)


def _operands(seed, bm, bk, d, dtype, dev, n_rb=5, n_cb=6, n_tiles=11):
    """Row block 1 empty, a sentinel inside the first segment, three
    sentinel pad entries on the last row."""
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < n_tiles:
        r = int(rng.integers(0, n_rb))
        if r != 1:
            pairs.add((r, int(rng.integers(0, n_cb))))
    entries = sorted(pairs)
    s = len(entries)
    rows, cols, sel = ([e[0] for e in entries], [e[1] for e in entries],
                       list(range(s)))
    sel.insert(1, s)
    rows.insert(1, rows[0])
    cols.insert(1, 0)
    sel, rows, cols = sel + [s] * 3, rows + [rows[-1]] * 3, cols + [0] * 3
    blocks = rng.standard_normal((s + 1, bm, bk)).astype(np.float32)
    blocks[s] = 0.0

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, DTYPES[dtype])

    ids = [torch.tensor(x, dtype=torch.int32, device=dev)
           for x in (sel, rows, cols)]
    return dict(blocks=torch.from_numpy(blocks).to(dev, DTYPES[dtype]),
                sel=ids[0], row_ids=ids[1], col_ids=ids[2],
                h=f(n_cb * bk, d), bias=f(d), residual=f(n_rb * bm, d),
                n_rb=n_rb)


@pytest.mark.parametrize("bm,bk,d", [(8, 8, 41), (32, 16, 256),
                                     (128, 128, 41), (64, 64, 602)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias_on,res_on,relu", EPILOGUES)
def test_kernel_matches_plain_version(cuda, bm, bk, d, dtype, bias_on,
                                      res_on, relu):
    c = _operands(bm + d, bm, bk, d, dtype, cuda)
    args = (c["blocks"], c["sel"], c["row_ids"], c["col_ids"], c["h"])
    kw = dict(n_row_blocks=c["n_rb"], bm=bm, bk=bk, relu=relu,
              bias=c["bias"] if bias_on else None,
              residual=c["residual"] if res_on else None)
    before = kmod.launches
    out = ops.bcoo_spmm(*args, **kw)
    torch.cuda.synchronize()
    assert kmod.launches == before + 1
    assert out.dtype == DTYPES[dtype] and out.is_contiguous()
    _close(out, bcoo_spmm_ref(*args, **kw), dtype)


@pytest.mark.parametrize("bd", [None, 8, 96])
def test_kernel_column_tiles(cuda, bd):
    """Every dispatched column tile (the default, a small one, and one
    that does not divide d and falls back to the gcd) gives the same
    answer."""
    c = _operands(3, 16, 16, 72, "f32", cuda)
    args = (c["blocks"], c["sel"], c["row_ids"], c["col_ids"], c["h"])
    out = ops.bcoo_spmm(*args, n_row_blocks=c["n_rb"], bm=16, bk=16, bd=bd)
    _close(out, bcoo_spmm_ref(*args, n_row_blocks=c["n_rb"], bm=16, bk=16),
           "f32")


@pytest.mark.parametrize("case", ["non_contiguous", "sel_range",
                                  "col_range", "device_mix"])
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda, case):
    c = _operands(4, 8, 8, 16, "f32", cuda)
    kw = dict(n_row_blocks=c["n_rb"], bm=8, bk=8, bd=16)
    if case == "non_contiguous":
        c["h"] = torch.cat([c["h"], c["h"]], dim=1)[:, ::2]
    elif case == "sel_range":
        c["sel"][0] = c["blocks"].shape[0]
    elif case == "col_range":
        c["col_ids"][0] = c["h"].shape[0] // 8
    elif case == "device_mix":
        kw["row_ptr"] = torch.zeros(c["n_rb"] + 1, dtype=torch.int32)
    before = kmod.launches
    with pytest.raises(ValueError):
        kmod.bcoo_spmm(c["blocks"], c["sel"], c["row_ids"], c["col_ids"],
                       c["h"], **kw)
    assert kmod.launches == before


@pytest.mark.parametrize("batchnorm", [True, False])
def test_stream_forward_on_cuda_matches_cpu(cuda, batchnorm):
    """The serving forward through the kernel == the same forward through
    the plain version on the CPU, with one launch per layer and
    partition."""
    g = sbm_graph(n_nodes=600, n_clusters=5, avg_degree=10, feat_dim=24,
                  seed=2)
    cfg = dict(block=32, n_partitions=3, memory_budget_mb=None)
    net = gcn.init(24, 48, 5, 3, batchnorm, seed=1)
    cpu = StreamingInference(g, "gcn", net, StreamConfig(device="cpu",
                                                         **cfg))
    dev = StreamingInference(g, "gcn", gcn.init(24, 48, 5, 3, batchnorm,
                                                seed=1, device=cuda),
                             StreamConfig(device="cuda", **cfg))
    ops.reset_launch_counts()
    logits = dev.forward()
    assert ops.launch_counts()["bcoo_spmm"] == 3 * dev.n_partitions
    ref = cpu.forward()
    np.testing.assert_allclose(logits, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))
