"""The CUDA kernels of the port on the card: ``bcoo_spmm``,
``gather_matmul`` and ``flash_attention`` against their plain PyTorch
versions (the wgmma variants and ``bcoo_spmm``'s tensor-core variants also
at the edges of their tiles, each launch counted under its variant), the
wrappers' refusals, and the streaming GCN forward, the LM
prefill + decode, ``rsc_matmul``, LM training steps and full-batch GCN
training with RSC on ``cuda`` against the same runs on the CPU; the
training path's no-sync entry ``bcoo_spmm_in_range``; a minibatch run
restored from its step-9 checkpoint on the card against the uninterrupted
run (bit for bit), and a full-batch run with observability on against the
same run with it off (equal losses).

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor ``repro``, so it runs on a machine with only
PyTorch; from the repository root there:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: f32 at rtol 1e-4 and atol 1e-4·max|ref| (the kernel and the
plain version sum the same f32 products in different orders); bf16
compared in f32 at rtol 2e-2 and atol 1e-3·max|ref| (one f32 sum rounded
once to 8 significant bits on each side, so the order can flip the last
bit). Flash attention, scaled to each output row (a row's size falls as
1/sqrt(keys it sees)): element-wise atol min(a, r·rms(ref row)) and rtol
2e-2, with a = 2e-4 (f32) or 5e-2 (bf16), the tolerances of
``tests/test_kernels.py``, and r = 1e-3 or 5e-2; and each row's L2 error
within 1e-4 (f32) or 1e-2 (bf16) of its norm. The kernel rounds P to bf16
before P·V in bf16; the plain version does not. ``gather_matmul``,
scaled to the data: element-wise rtol r and atol a·rms(ref row), and the
Frobenius error within n of the norm, with (r, a, n) = (1e-4, 1e-4, 1e-4)
in f32 and (1e-2, 1e-3, 2e-3) in bf16 (both sides sum exact products in
f32 and round once, so a bf16 element may differ by one unit of its last
place). Training on the card against the CPU: equal selected blocks,
losses within 1e-5 relative and each parameter's change within
``TRAIN_DP_REL`` of the CPU run's change in L2 norm (``chip_smoke.py``'s
limit).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.graphs.synthetic import sbm_graph
from repro_torch.infer import StreamConfig, StreamingInference
from repro_torch.configs import make_batch, smoke_config
from repro_torch.core.plan import plan_row_ptr
from repro_torch.kernels import bcoo_spmm as kmod
from repro_torch.core import rsc_matmul as rsc
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import gather_matmul as gmod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import bcoo_spmm_ref, flash_attention_ref, \
    gather_matmul_ref
from repro_torch.launch import serve
from repro_torch.models.gnn import gcn
from repro_torch.models.lm.backbone import init_params
from repro_torch.train.lm_steps import make_train_step
from repro_torch.train.loop import GNNTrainer, TrainConfig
from repro_torch.train.optimizer import Adam

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


def test_in_range_entry_skips_the_host_check(cuda, monkeypatch):
    """``bcoo_spmm_in_range`` (the training path's entry) launches the
    kernel without the host check of the indices (which reads them back
    from the card); the checked entry still runs it."""
    c = _operands(6, 32, 32, 64, "f32", cuda)
    args = (c["blocks"], c["sel"], c["row_ids"], c["col_ids"], c["h"])
    kw = dict(n_row_blocks=c["n_rb"], bm=32, bk=32, bias=c["bias"],
              residual=c["residual"], relu=True)
    ref = bcoo_spmm_ref(*args, **kw)

    def refuse(*a, **k):
        raise AssertionError("host index check called")

    monkeypatch.setattr(kmod, "_check_indices", refuse)
    before = kmod.launches
    out = ops.bcoo_spmm_in_range(*args, **kw)
    torch.cuda.synchronize()
    assert kmod.launches == before + 1
    _close(out, ref, "f32")
    with pytest.raises(AssertionError, match="host index check"):
        ops.bcoo_spmm(*args, **kw)


def _segments(seed, segs, pad, bm, bk, d, dtype, dev):
    """Row block i holds ``segs[i]`` tiles, and the last row ``pad``
    sentinel entries after them."""
    rng = np.random.default_rng(seed)
    n_cb = max(segs) + 3
    rows, cols = [], []
    for r, n in enumerate(segs):
        rows += [r] * n
        cols += sorted(rng.choice(n_cb, n, replace=False).tolist())
    s = len(rows)
    sel = list(range(s)) + [s] * pad
    rows, cols = rows + [len(segs) - 1] * pad, cols + [0] * pad
    blocks = rng.standard_normal((s + 1, bm, bk)).astype(np.float32)
    blocks[s] = 0.0

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, DTYPES[dtype])

    ids = [torch.tensor(x, dtype=torch.int32, device=dev)
           for x in (sel, rows, cols)]
    return dict(blocks=torch.from_numpy(blocks).to(dev, DTYPES[dtype]),
                sel=ids[0], row_ids=ids[1], col_ids=ids[2],
                h=f(n_cb * bk, d), bias=f(d), residual=f(len(segs) * bm, d),
                n_rb=len(segs))


# (tiles per row block, sentinel padding of the last row, bm, bk, d,
# split): long segments over few row blocks (split into chunks), a
# 1,500-entry run of padding, a sampled backward plan's 1-4-tile segments
# (one chunk), 8 x 8 tiles (below one 16-row fragment), and ragged widths
# 41 and 602.
TC_EDGES = [([320, 7, 0, 40], 0, 128, 128, 256, True),
            ([320, 7, 0, 40], 0, 128, 128, 41, True),
            ([12, 9, 10], 1500, 128, 128, 256, True),
            ([1, 2, 3, 4, 0, 1] * 10 + [2, 3], 0, 128, 128, 41, False),
            ([40, 3, 0, 25], 40, 8, 8, 41, True),
            ([40, 3, 0, 25], 40, 8, 8, 602, True),
            ([200, 1, 60], 3, 64, 64, 602, True)]


@pytest.mark.parametrize("segs,pad,bm,bk,d,split", TC_EDGES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tensor_core_variant_edges(cuda, segs, pad, bm, bk, d, split,
                                   dtype):
    """The tensor-core variant at its edges: against the plain version,
    counted once under its variant, two launches bit-equal, segments split
    exactly when they are long, and a narrower column tile."""
    c = _segments(len(segs) + d, segs, pad, bm, bk, d, dtype, cuda)
    args = (c["blocks"], c["sel"], c["row_ids"], c["col_ids"], c["h"])
    kw = dict(n_row_blocks=c["n_rb"], bm=bm, bk=bk, relu=True,
              bias=c["bias"], residual=c["residual"])
    var = kmod.variant(DTYPES[dtype], bm, bk, d)
    assert var == {"f32": "tf32x3", "bf16": "mma"}[dtype]
    before = kmod.launches_by_variant[var]
    out = ops.bcoo_spmm(*args, **kw)
    again = ops.bcoo_spmm(*args, **kw)
    torch.cuda.synchronize()
    assert kmod.launches_by_variant[var] == before + 2
    assert torch.equal(out, again)
    _close(out, bcoo_spmm_ref(*args, **kw), dtype)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = kmod.chunks(c["n_rb"], c["sel"].shape[0], d,
                         ops.resolve_bd(None, d), n_sm)
    assert (splits > 1) == split
    # a narrower dispatched column tile: another grid, the same function
    narrow = ops.bcoo_spmm(*args, bd=d // 2 if d % 2 == 0 else 1, **kw)
    _close(narrow, bcoo_spmm_ref(*args, **kw), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fma_variant_forced(cuda, dtype):
    """The FMA variant, kept for bk not a multiple of 8, on the inputs a
    tensor-core variant takes, and on bk = 12 where it is picked."""
    for bm, bk in ((32, 32), (16, 12)):
        c = _operands(bm + bk, bm, bk, 41, dtype, cuda)
        args = (c["blocks"], c["sel"], c["row_ids"], c["col_ids"], c["h"])
        kw = dict(n_row_blocks=c["n_rb"], bm=bm, bk=bk, relu=True,
                  bias=c["bias"], residual=c["residual"])
        ref = bcoo_spmm_ref(*args, **kw)
        out = torch.empty_like(ref)
        before = kmod.launches_by_variant["fma"]
        kmod.launch(c["blocks"], c["sel"], c["col_ids"],
                    plan_row_ptr(c["row_ids"], c["n_rb"]), c["h"],
                    c["bias"], c["residual"], out, bm=bm, bk=bk, bd=41,
                    relu=True, force="fma")
        torch.cuda.synchronize()
        assert kmod.launches_by_variant["fma"] == before + 1
        _close(out, ref, dtype)
        if bk % 8:
            assert kmod.variant(DTYPES[dtype], bm, bk, 41) == "fma"
            _close(ops.bcoo_spmm(*args, **kw), ref, dtype)


@pytest.mark.parametrize("batchnorm", [True, False])
def test_stream_forward_on_cuda_matches_cpu(cuda, batchnorm):
    """The serving forward through the kernel == the same forward through
    the plain version on the CPU, with one launch per layer and
    partition."""
    g = sbm_graph(n_nodes=600, n_clusters=5, avg_degree=10, feat_dim=24,
                  seed=2)
    cfg = dict(block=32, n_partitions=3, memory_budget_mb=None)
    net = gcn.init(24, 48, 5, 3, batchnorm, seed=1, device="cpu")
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


# (b, tq, tk, nq, nkv, hd, causal, window, q_offset): one token, odd
# lengths, GQA 14/2 and 8/1, windows wider and narrower than a tile,
# q_offset = tk - tq, rows that see no key (q_offset past the window, or
# negative under causal), non-causal, and the smoke configs' hd 16.
# Lengths up to 300 span several kv tiles, so a tile skipped or counted
# twice shows.
FLASH_CASES = [
    (1, 1, 1, 16, 8, 128, True, None, 0),
    (2, 7, 7, 14, 2, 64, True, 16, 0),
    (1, 257, 257, 4, 4, 128, False, None, 0),
    (2, 64, 64, 8, 1, 64, True, 100, 0),
    (1, 33, 300, 16, 8, 128, True, None, 267),
    (1, 12, 20, 4, 2, 64, True, 4, 40),
    (1, 65, 65, 4, 2, 128, False, 6, 0),
    (2, 130, 130, 16, 8, 64, True, None, -3),
    (1, 40, 40, 4, 2, 16, True, 16, 0),
    (2, 9, 9, 4, 4, 64, False, None, 0),
]
# (atol cap, atol per unit of row rms, row L2 error per unit of row norm)
FLASH_TOL = {"f32": (2e-4, 1e-3, 1e-4), "bf16": (5e-2, 5e-2, 1e-2)}


def _flash_close(out, ref, dtype):
    out, ref = out.float().cpu(), ref.float().cpu()
    cap, row, row_l2 = FLASH_TOL[dtype]
    err = (out - ref).abs()
    atol = (row * ref.square().mean(-1, keepdim=True).sqrt()).clamp(max=cap)
    assert not (err > atol + 2e-2 * ref.abs()).any(), float(err.max())
    rel = err.norm(dim=-1) / ref.norm(dim=-1).clamp(min=1e-30)
    assert float(rel.max()) <= row_l2, float(rel.max())


def _qkv(seed, b, tq, tk, nq, nkv, hd, dtype, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev, DTYPES[dtype]) for s in ((b, tq, nq, hd), (b, tk, nkv, hd),
                                      (b, tk, nkv, hd))]


@pytest.mark.parametrize("b,tq,tk,nq,nkv,hd,causal,window,q_offset",
                         FLASH_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_kernel_matches_plain_version(cuda, b, tq, tk, nq, nkv, hd,
                                            causal, window, q_offset, dtype):
    q, k, v = _qkv(tq + tk + hd, b, tq, tk, nq, nkv, hd, dtype, cuda)
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    before = fmod.launches
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fmod.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    _flash_close(out, flash_attention_ref(q, k, v, **kw), dtype)


# The wgmma variant's edges (bf16): tq and tk not multiples of its 128-row
# tiles, tq < tk with q_offset > 0, windows, GQA ratios 1, 2, 7 and 8, hd
# 64 and 128, rows that see no key (q_offset < 0 under causal; every key
# left of a window) and one query.
FLASH_WGMMA_CASES = [
    (1, 129, 129, 4, 4, 128, True, None, 0),
    (2, 100, 385, 16, 8, 64, True, None, 285),
    (1, 300, 300, 14, 2, 128, True, 100, 0),
    (2, 64, 257, 8, 1, 64, False, 16, 193),
    (1, 257, 1000, 14, 2, 128, False, None, 0),
    (1, 130, 200, 4, 2, 128, True, None, -5),
    (1, 64, 64, 4, 4, 64, True, 8, 100),
    (1, 1, 1, 8, 1, 128, True, None, 0)]


@pytest.mark.parametrize("b,tq,tk,nq,nkv,hd,causal,window,q_offset",
                         FLASH_WGMMA_CASES)
def test_flash_wgmma_variant_edges(cuda, b, tq, tk, nq, nkv, hd, causal,
                                   window, q_offset):
    q, k, v = _qkv(tq * 3 + tk + hd, b, tq, tk, nq, nkv, hd, "bf16", cuda)
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    assert fmod.variant(q.dtype, hd) == "wgmma"
    before = dict(fmod.launches_by_variant)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fmod.launches_by_variant == {**before,
                                        "wgmma": before["wgmma"] + 1}
    _flash_close(out, flash_attention_ref(q, k, v, **kw), "bf16")


@pytest.mark.parametrize("case", ["head_dim", "device_mix",
                                  "non_contiguous"])
def test_flash_wrapper_refuses_what_the_kernel_cannot_take(cuda, case):
    q, k, v = _qkv(1, 1, 8, 8, 4, 2, 64, "bf16", cuda)
    if case == "head_dim":
        q, k, v = _qkv(1, 1, 8, 8, 4, 2, 96, "bf16", cuda)
    elif case == "device_mix":
        k = k.cpu()
    elif case == "non_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = fmod.launches
    with pytest.raises(ValueError):
        fmod.flash_attention(q, k, v)
    assert fmod.launches == before


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-0.5b"])
def test_lm_prefill_decode_on_cuda_matches_cpu(cuda, arch):
    """f32 smoke model: the same logits and greedy tokens on the card as
    on the CPU (plain versions), with one kernel launch per layer in the
    prefill and none in decode. Tolerance 1e-4·max|logit|."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    runs = []
    for dev in ("cpu", cuda):
        net = init_params(cfg, seed=0, device="cpu").to(dev)
        prompt = make_batch(cfg, "prefill_32k", 2, 40, seed=1, device=dev)
        ops.reset_launch_counts()
        toks, _, rec = serve.greedy_generate(cfg, net, prompt, 48, 6)
        runs.append((toks, rec))
    (ctoks, crec), (gtoks, grec) = runs
    assert grec["launches"]["prefill"]["flash_attention"] == cfg.n_layers
    assert grec["launches"]["decode"]["flash_attention"] == 0
    assert torch.equal(ctoks, gtoks)
    for phase in ("prefill", "last"):
        ref = crec["logits"][phase]
        torch.testing.assert_close(
            grec["logits"][phase].cpu(), ref, rtol=0,
            atol=1e-4 * float(ref.abs().max()))


# (n_blocks, bk, m, q, k_sel): one block, ragged widths (41, 96, 130),
# every bk, k_sel of 1, half and all, and the training shape's 2048 x 6144.
GATHER_CASES = [
    (1, 32, 41, 96, 1), (3, 64, 96, 41, 2), (3, 128, 130, 264, 3),
    (8, 32, 64, 128, 4), (64, 128, 2048, 6144, 32), (5, 32, 7, 9, 5)]
GATHER_TOL = {"f32": (1e-4, 1e-4, 1e-4), "bf16": (1e-2, 1e-3, 2e-3)}
TRAIN_DP_REL = 1e-3


def _gather_close(out, ref, dtype):
    out, ref = out.float().cpu(), ref.float().cpu()
    rtol, row, norm = GATHER_TOL[dtype]
    err = (out - ref).abs()
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    assert not (err > rtol * ref.abs() + row * rms).any(), float(err.max())
    assert float((out - ref).norm() / ref.norm()) <= norm


def _gather_operands(seed, n_blocks, bk, m, q, k_sel, dtype, dev):
    rng = np.random.default_rng(seed)
    x, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev, DTYPES[dtype]) for s in ((n_blocks * bk, m), (n_blocks * bk, q)))
    idx = np.sort(rng.choice(n_blocks, k_sel, replace=False))
    return x, g, torch.from_numpy(idx.astype(np.int32)).to(dev)


@pytest.mark.parametrize("n_blocks,bk,m,q,k_sel", GATHER_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_kernel_matches_plain_version(cuda, n_blocks, bk, m, q, k_sel,
                                             dtype):
    x, g, idx = _gather_operands(m + q, n_blocks, bk, m, q, k_sel, dtype,
                                 cuda)
    before = gmod.launches
    out = ops.gather_matmul(x, g, idx, bk=bk)
    torch.cuda.synchronize()
    assert gmod.launches == before + 1
    assert out.dtype == x.dtype and out.shape == (m, q)
    _gather_close(out, gather_matmul_ref(x, g, idx, bk=bk), dtype)


# The wgmma variant's edges (bf16, m and q multiples of 8): widths that are
# not multiples of its 128 x 256 tiles, k_sel 1, bk 32, 64, 96 (32-token
# stages) and 128, both training shapes.
GATHER_WGMMA_CASES = [
    (1, 32, 200, 264, 1), (3, 64, 200, 264, 2), (4, 128, 264, 200, 4),
    (2, 96, 8, 520, 2), (3, 128, 2048, 6144, 1), (64, 128, 6144, 2048, 32)]


@pytest.mark.parametrize("n_blocks,bk,m,q,k_sel", GATHER_WGMMA_CASES)
def test_gather_wgmma_variant_edges(cuda, n_blocks, bk, m, q, k_sel):
    x, g, idx = _gather_operands(m * 7 + q, n_blocks, bk, m, q, k_sel,
                                 "bf16", cuda)
    assert gmod.variant(x.dtype, m, q) == "wgmma"
    before = dict(gmod.launches_by_variant)
    out = ops.gather_matmul(x, g, idx, bk=bk)
    torch.cuda.synchronize()
    assert gmod.launches_by_variant == {**before,
                                        "wgmma": before["wgmma"] + 1}
    _gather_close(out, gather_matmul_ref(x, g, idx, bk=bk), "bf16")


@pytest.mark.parametrize("case", ["past_end", "negative", "bk", "device_mix",
                                  "non_contiguous", "empty"])
def test_gather_wrapper_refuses_what_the_kernel_cannot_take(cuda, case):
    x, g, idx = _gather_operands(0, 4, 32, 16, 24, 2, "bf16", cuda)
    kw = dict(bk=32)
    if case == "past_end":
        idx[-1] = 4
    elif case == "negative":
        idx[0] = -1
    elif case == "bk":
        kw["bk"] = 16
    elif case == "device_mix":
        idx = idx.cpu()
    elif case == "non_contiguous":
        g = torch.cat([g, g], dim=1)[:, ::2]
    elif case == "empty":
        idx = idx[:0]
    before = gmod.launches
    with pytest.raises(ValueError):
        gmod.gather_matmul(x, g, idx, **kw)
    assert gmod.launches == before


def test_rsc_matmul_on_cuda_matches_cpu(cuda):
    """Forward, dx and the sampled dW through the kernel against the CPU
    (plain version), f32, with the same blocks selected."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 256, 48)).astype(np.float32)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    ct = rng.standard_normal((2, 256, 40)).astype(np.float32)
    res = []
    for dev in ("cpu", cuda):
        tx, tw = (torch.from_numpy(a).to(dev).requires_grad_()
                  for a in (x, w))
        y = rsc.rsc_matmul(tx, tw, 0.5, 32)
        dx, dw = torch.autograd.grad(y, (tx, tw),
                                     torch.from_numpy(ct).to(dev))
        idx = rsc.select_blocks(tx.detach().reshape(-1, 48),
                                torch.from_numpy(ct).to(dev).reshape(-1, 40),
                                8, 32)
        res.append([t.detach().cpu() for t in (y, dx, dw, idx)])
    (cy, cdx, cdw, cidx), (gy, gdx, gdw, gidx) = res
    assert torch.equal(cidx, gidx)
    for got, ref in ((gy, cy), (gdx, cdx), (gdw, cdw)):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))


def test_rsc_ref_backend_refuses_cuda_tensors(cuda):
    """Backend ``"ref"`` is CPU-only: on the card the sampled dW runs the
    kernel or the call raises, with no launch."""
    x = torch.randn(2, 64, 48, device=cuda, requires_grad=True)
    w = torch.randn(48, 40, device=cuda, requires_grad=True)
    before = gmod.launches
    with pytest.raises(ValueError):
        rsc.rsc_matmul(x, w, 0.5, 32, backend="ref")
    with pytest.raises(ValueError):
        rsc.sampled_xt_g(x.detach().reshape(-1, 48),
                         torch.randn(128, 40, device=cuda), 2, 32,
                         backend="ref")
    assert gmod.launches == before


def test_lm_train_steps_on_cuda_match_cpu(cuda):
    """Three RSC training steps of the f32 smoke qwen3-1.7b (bk 32, 2
    microbatches) on the card and on the CPU from one parameter set, with
    3 kernel launches per layer per microbatch on the card."""
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), dtype="float32")
    lr, steps = 1e-3, 3
    nets = {"cpu": init_params(cfg, seed=0, device="cpu")}
    nets["cuda"] = init_params(cfg, seed=0, device="cpu").to(cuda)
    start = {k: p.detach().clone() for k, p in nets["cpu"].named_parameters()}
    losses = {}
    for name, net in nets.items():
        opt = Adam(lr=lr, clip_norm=1.0)
        state = opt.init(dict(net.named_parameters()))
        step = make_train_step(cfg, opt, 2, rsc={"keep_frac": 0.5, "bk": 32})
        ops.reset_launch_counts()
        losses[name] = []
        for i in range(steps):
            batch = make_batch(cfg, "train_4k", 4, 64, seed=i,
                               device=net.embed.device)
            net, state, loss = step(net, state, batch)
            losses[name].append(float(loss))
        want = 0 if name == "cpu" else 3 * cfg.n_layers * 2 * steps
        assert ops.launch_counts()["gather_matmul"] == want
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for (k, a), (_, b) in zip(nets["cpu"].named_parameters(),
                              nets["cuda"].named_parameters()):
        moved = a.detach() - start[k]
        err = (b.detach().cpu() - a.detach()).norm()
        assert float(err) <= TRAIN_DP_REL * float(moved.norm()), k


def test_gnn_train_on_cuda_matches_cpu(cuda):
    """15 full-batch RSC steps of a small GCN (2 × 48, block 32, so the
    ``tf32x3`` variant; dropout 0; budget 0.3) on the card and on the CPU
    from one parameter set. The CPU planner is fed the card's ∇H norms,
    so the plans are the same by construction (checked); losses within
    1e-4 relative and each parameter's change within ``TRAIN_DP_REL`` of
    the CPU run's (``chip_smoke.py``'s limits for its 30-step run)."""
    graph = sbm_graph(n_nodes=700, n_clusters=7, avg_degree=12,
                      feat_dim=32, seed=0)
    cfg = dict(model="gcn", n_layers=2, hidden=48, block=32, dropout=0.0,
               rsc=True, budget=0.3, epochs=15)   # refresh at step 10
    cpu_net = gcn.init(32, 48, 7, 2, True, seed=0, device="cpu")
    start = {k: p.detach().clone() for k, p in cpu_net.named_parameters()}
    nets = {"cuda": copy.deepcopy(cpu_net).to(cuda), "cpu": cpu_net}
    runs, card_norms = {}, []
    for name, net in nets.items():
        tr = GNNTrainer(TrainConfig(**cfg, device=name), graph, model=net)
        planner, plans = tr.engine.planner, []
        plans_for, record = planner.plans_for, planner.record
        fed = iter(card_norms)

        def wrapped_plans_for(tag, step, schedule, plans_for=plans_for,
                              plans=plans):
            out = plans_for(tag, step, schedule)
            plans.append([p.sel.cpu() for p in out.values()])
            return out

        def wrapped_record(tag, norms, record=record, name=name, fed=fed):
            if name == "cuda":
                card_norms.append({k: v.cpu() for k, v in norms.items()})
                record(tag, norms)
            else:
                record(tag, next(fed))

        planner.plans_for, planner.record = wrapped_plans_for, wrapped_record
        ops.reset_launch_counts()
        res = tr.train(eval_every=5)
        runs[name] = (res, plans, ops.launch_counts()["bcoo_spmm"])
    (gres, gplans, glaunch), (cres, cplans, claunch) = runs["cuda"], \
        runs["cpu"]
    assert claunch == 0
    assert glaunch == 4 * 15 + 2 * len(gres["history"]["val"])
    assert all(torch.equal(a, b) for x, y in zip(gplans, cplans)
               for a, b in zip(x, y))
    assert gres["flops_fraction"] == cres["flops_fraction"] <= 0.3
    np.testing.assert_allclose(gres["history"]["loss"],
                               cres["history"]["loss"], rtol=1e-4)
    for (k, a), (_, b) in zip(nets["cpu"].named_parameters(),
                              nets["cuda"].named_parameters()):
        moved = a.detach() - start[k]
        err = (b.detach().cpu() - a.detach()).norm()
        assert float(err) <= TRAIN_DP_REL * float(moved.norm()), k


@pytest.mark.parametrize("resident", [0, 2])
def test_prefetcher_side_stream_matches_synchronous_upload(cuda, resident):
    """The CUDA ``Prefetcher`` (pinned host copies, a side stream, an event
    the consumer waits on, ``record_stream``) hands the step the same bits
    as a synchronous upload, over two passes of a schedule, while the
    consumer's stream is kept busy so a missing wait would show."""
    from repro_torch.graphs.datasets import load_dataset
    from repro_torch.pipeline import (PoolConfig, Prefetcher, build_pool,
                                      device_operands)
    from repro_torch.pipeline.prefetch import operand_tensors
    g = load_dataset("reddit", scale=0.004, seed=0)
    pool = build_pool(g, PoolConfig(n_subgraphs=4, roots=50, walk_length=2,
                                    n_buckets=2, block=32))
    schedule = [2, 0, 3, 1, 0, 2]
    want = {sid: [t.cpu() for t in operand_tensors(
        device_operands(pool, pool.subgraphs[sid], cuda))]
        for sid in set(schedule)}
    cache, pinned = None, {}
    busy = torch.randn(4096, 4096, device=cuda)
    for _ in range(2):
        fetch = Prefetcher(pool, schedule, device=cuda, resident=resident,
                           cache=cache, pinned=pinned)
        for sid, ops_ in fetch:
            busy = busy @ busy / 64.0       # the consumer's stream is busy
            got = [t.clone() for t in operand_tensors(ops_)]
            for a, b in zip(got, want[sid]):
                assert torch.equal(a.cpu(), b)
        cache = fetch._cache
        assert fetch.uploads + fetch.resident_hits == len(schedule)
    assert len(pinned) == 4 and all(
        t.is_pinned() for ts in pinned.values() for t in ts.values())


def _mb_resume_cfg(tmp_path):
    """The small minibatch run of ``chip_smoke.py`` phase 8e (c): GCN 2 ×
    48, block 32, a 4-subgraph random-walk pool in 2 buckets, RSC at
    budget 0.3, dropout 0.5, prefetch on, a checkpoint every 9 steps."""
    from repro_torch.pipeline import MinibatchConfig
    return MinibatchConfig(
        model="gcn", n_layers=2, hidden=48, block=32, batchnorm=True,
        dropout=0.5, rsc=True, budget=0.3, epochs=6, n_subgraphs=4,
        n_buckets=2, roots=100, walk_length=2, autotune=False,
        refresh_every=2, ckpt_dir=str(tmp_path), ckpt_every=9,
        device="cuda")


def test_minibatch_resume_on_cuda_is_step_exact(cuda, tmp_path):
    """Restored at step 9 (mid-epoch) on the card, the run continues with
    the uninterrupted run's losses and final parameters, bit for bit (the
    kernel is deterministic, and so is every other op of the step; the
    dropout generator's state rides in the checkpoint)."""
    from repro_torch.pipeline import MinibatchTrainer
    graph = sbm_graph(n_nodes=700, n_clusters=7, avg_degree=12,
                      feat_dim=32, seed=0)
    a = MinibatchTrainer(_mb_resume_cfg(tmp_path), graph)
    ra = a.train(eval_every=3)
    b = MinibatchTrainer(_mb_resume_cfg(tmp_path), graph)
    assert b.engine.restore(step=9) == 9
    rb = b.train(eval_every=3)
    assert rb["history"]["loss"] == ra["history"]["loss"][9:]
    assert rb["history"]["sub_id"] == ra["history"]["sub_id"][9:]
    for (k, x), (_, y) in zip(a.params.named_parameters(),
                              b.params.named_parameters()):
        assert torch.equal(x, y), k


def test_gnn_train_obs_on_off_same_losses_on_cuda(cuda):
    """Metrics, tracing, the ledger and the probes change no number of a
    full-batch RSC run on the card (dropout on, so the generator's draws
    are part of it)."""
    from repro_torch import obs
    graph = sbm_graph(n_nodes=700, n_clusters=7, avg_degree=12,
                      feat_dim=32, seed=0)
    cfg = TrainConfig(model="gcn", n_layers=2, hidden=48, block=32,
                      dropout=0.5, rsc=True, budget=0.3, epochs=20,
                      device="cuda")
    losses = {}
    try:
        for on in (False, True):
            ob = obs.reset(metrics=on, trace=on, ledger=on)
            res = GNNTrainer(cfg, graph).train(eval_every=5)
            losses[on] = res["history"]["loss"]
        assert ob.registry.get_histogram("engine.step_ms", mode="rsc")[
            "count"] == res["history"]["mode"].count("rsc")
        assert res["ledger"]["probes"]
    finally:
        obs.reset()
    assert losses[True] == losses[False]
