"""The work counts: from the graph and the widths, whatever block size the
program tiles with; dense FLOPs as torch's own counter sees the reference
step; the sampled backward's entries as a brute-force count finds them."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import gb_graph
import gb_reference
import gb_work

CFG = {"n_layers": 3, "hidden": 16, "batchnorm": True, "dropout": 0.0,
       "lr": 0.01, "feat_dim": 24, "classes": 5}


def graph():
    return gb_graph.sbm_graph(256, 5, 10.0, 24, seed=3)


def row_nnz(g, model):
    r = np.diff(g.rowptr)[gb_reference.degree_order(g.rowptr)]
    return r + 1 if model == "gcn" else r


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_exact_step_count_ignores_the_block(model):
    g = graph()
    cfg = {**CFG, "model": model}
    counts = []
    for block in (64, 128):
        w = gb_work.step(cfg, gb_work.GraphWork.of(row_nnz(g, model), block))
        counts.append((w.flops, w.spmm_flops, w.spmm_least_s,
                       w.spmm_launches))
    assert counts[0] == counts[1]


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_counts_match_torch_flop_counter(model):
    """Dense FLOPs of one exact step as ``FlopCounterMode`` counts the
    reference's products (the graph's 256 nodes are two whole 128-row
    blocks, so the reference computes on the real rows only), and the
    SpMMs at 2 nnz d each."""
    g = graph()
    cfg = {**CFG, "model": model, "block": 128}
    ops = gb_reference.build_operands(g, model, 128, "cpu")
    shapes = gb_reference.leaf_shapes(cfg, cfg["classes"])
    p = {k: torch.randn(s, requires_grad=True) for k, s in shapes.items()}
    with FlopCounterMode(display=False) as fc:
        logits, _ = gb_reference.forward(cfg, p, ops, masks=None, keep=None,
                                         low=False)
        gb_reference.loss_of(logits, ops).backward()
    w = gb_work.step(cfg, gb_work.GraphWork.of(row_nnz(g, model), 128))
    assert fc.get_total_flops() == w.flops - w.spmm_flops
    nnz = int(row_nnz(g, model).sum())
    widths = ([16, 16, 5] if model == "gcn" else [24, 16, 16])
    bwd = widths if model == "gcn" else widths[1:]
    assert w.spmm_flops == sum(2 * nnz * d for d in widths + bwd)
    assert w.spmm_launches == len(widths) + len(bwd)


def test_sampled_backward_counts_kept_blocks():
    g = graph()
    r = row_nnz(g, "gcn")
    gw = gb_work.GraphWork.of(r, 32)
    keep = np.zeros(8, bool)
    keep[[0, 3, 7]] = True
    nnz, rows = gw.kept(keep)
    blk = np.arange(g.n) // 32
    assert nnz == int(sum(r[i] for i in range(g.n) if keep[blk[i]]))
    assert rows == int(np.isin(blk, [0, 3, 7]).sum())
    assert gw.kept(None) == (int(r.sum()), g.n)
    full = gb_work.step({**CFG, "model": "gcn"}, gw)
    sampled = gb_work.step({**CFG, "model": "gcn"}, gw,
                           keep={0: keep, 1: keep, 2: keep})
    assert sampled.spmm_flops < full.spmm_flops
    assert sampled.flops - sampled.spmm_flops == full.flops - full.spmm_flops


def test_least_time_takes_the_larger_bound():
    # an SpMM of 1e6 entries at d = 256 over 2e4 rows is bandwidth-bound
    f = 2 * 1e6 * 256
    b = 8e6 + 4 * 256 * 4e4
    assert gb_work.least_s(f, b) == pytest.approx(b / gb_work.PEAK_BYTES_S)
    assert gb_work.least_s(1e15, 1.0) == pytest.approx(
        1e15 / gb_work.PEAK_FLOPS)
    assert gb_work.PEAK_FLOPS == pytest.approx(165e12)


def test_training_counts_plans_and_evaluations():
    g = graph()
    gw = gb_work.GraphWork.of(row_nnz(g, "gcn"), 32)
    cfg = {**CFG, "model": "gcn"}
    keep = np.zeros(8, bool)
    keep[:2] = True
    modes = ["rsc"] * 4 + ["exact"]
    t = gb_work.training(cfg, gw, modes, {2: {0: keep, 1: keep, 2: keep}},
                         [0, 4])
    full, samp = gb_work.step(cfg, gw), gb_work.step(
        cfg, gw, {0: keep, 1: keep, 2: keep})
    fwd = gb_work.Work()
    gb_work.forward(fwd, cfg, gw)
    assert t.flops == pytest.approx(3 * full.flops + 2 * samp.flops
                                    + 2 * fwd.flops)
