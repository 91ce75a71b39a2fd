"""The work a training needs, counted from the benchmark's own graph and the
layer widths: never from the program's tiles or format.

* An SpMM over an operand of ``nnz`` entries at width ``d``: ``2 nnz d``
  FLOPs; bytes: the CSR values and column ids read once (8 bytes an
  entry), the dense input rows it needs read once and the output written
  once (4 bytes a value). Row pointers are not counted.
* The sampled backward: the entries of the backward operand in the column
  blocks the plan kept, and the input rows of those blocks.
* A dense product ``(m, k) @ (k, n)``: ``2 m k n`` FLOPs, for the forward
  and for every gradient the step computes (features need none).
* A launch's least time: the larger of FLOPs over the f32-accurate peak and
  bytes over the memory bandwidth.

Elementwise work (batchnorm, ReLU, dropout, softmax, Adam) is not counted.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# NVIDIA H100 SXM, published dense rates at its 700 W power limit: 495
# TFLOP/s in TF32 over the three passes that make a product f32-accurate
# (3xTF32, the fastest such rate), and 3.35 TB/s of HBM3.
PEAK_FLOPS = 495e12 / 3
PEAK_BYTES_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


@dataclasses.dataclass(frozen=True)
class GraphWork:
    """What the counts need of the operand: its rows, entries, and the
    entries and rows of each ``block``-wide column block of its transpose
    (rows of the operand in degree order)."""

    n: int
    nnz: int
    block_nnz: np.ndarray
    block_rows: np.ndarray

    @staticmethod
    def of(row_nnz_in_degree_order: np.ndarray, block: int) -> "GraphWork":
        n = int(row_nnz_in_degree_order.shape[0])
        nb = -(-n // block)
        blk = np.arange(n) // block
        return GraphWork(
            n=n, nnz=int(row_nnz_in_degree_order.sum()),
            block_nnz=np.bincount(blk, row_nnz_in_degree_order,
                                  minlength=nb).astype(np.int64),
            block_rows=np.bincount(blk, minlength=nb).astype(np.int64))

    def kept(self, keep: np.ndarray | None) -> tuple[int, int]:
        """(entries, input rows) under a column-block keep mask (None:
        all)."""
        if keep is None:
            return self.nnz, self.n
        return (int(self.block_nnz[keep].sum()),
                int(self.block_rows[keep].sum()))


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    spmm_flops: float = 0.0
    spmm_least_s: float = 0.0
    spmm_launches: int = 0

    def dense(self, m: int, k: int, n: int, times: int = 1) -> None:
        self.flops += 2.0 * m * k * n * times

    def spmm(self, nnz: int, rows_in: int, rows_out: int, d: int) -> None:
        f = 2.0 * nnz * d
        b = 8.0 * nnz + 4.0 * d * (rows_in + rows_out)
        self.flops += f
        self.spmm_flops += f
        self.spmm_least_s += least_s(f, b)
        self.spmm_launches += 1


def dims_of(cfg: dict) -> list[int]:
    L = cfg["n_layers"]
    return [cfg["feat_dim"]] + [cfg["hidden"]] * (L - 1) + [cfg["classes"]]


def forward(w: Work, cfg: dict, g: GraphWork) -> None:
    dims = dims_of(cfg)
    for l in range(cfg["n_layers"]):
        if cfg["model"] == "gcn":
            w.dense(g.n, dims[l], dims[l + 1])
            w.spmm(g.nnz, g.n, g.n, dims[l + 1])
        else:
            w.spmm(g.nnz, g.n, g.n, dims[l])
            w.dense(g.n, dims[l], dims[l + 1], times=2)


def backward(w: Work, cfg: dict, g: GraphWork, keep: dict | None) -> None:
    """The gradients of one step; ``keep`` maps a sampled layer to its
    column-block keep mask (None, or a layer left out: exact)."""
    dims = dims_of(cfg)
    for l in range(cfg["n_layers"]):
        k = None if keep is None else keep.get(l)
        if cfg["model"] == "gcn":
            nnz, rows = g.kept(k)
            w.spmm(nnz, rows, g.n, dims[l + 1])
            w.dense(g.n, dims[l], dims[l + 1], times=2 if l else 1)
        else:
            w.dense(g.n, dims[l], dims[l + 1], times=2)
            if l:
                w.dense(g.n, dims[l], dims[l + 1], times=2)
                nnz, rows = g.kept(k)
                w.spmm(nnz, rows, g.n, dims[l])


def step(cfg: dict, g: GraphWork, keep: dict | None = None) -> Work:
    w = Work()
    forward(w, cfg, g)
    backward(w, cfg, g, keep)
    return w


def training(cfg: dict, g: GraphWork, modes: list[str], plans: dict,
             eval_epochs: list[int]) -> Work:
    """The work of a full-batch training: one step per epoch in ``modes``
    (``"rsc"`` or ``"exact"``), the plan in force at each RSC step (the
    latest entry of ``plans``, a step -> {layer: keep mask}, at or before
    it; none: exact), and one forward per evaluation."""
    w = Work()
    refreshes = sorted(plans)
    for s, mode in enumerate(modes):
        keep = None
        if mode == "rsc":
            at = [r for r in refreshes if r <= s]
            keep = plans[at[-1]] if at else None
        forward(w, cfg, g)
        backward(w, cfg, g, keep)
    for _ in eval_epochs:
        forward(w, cfg, g)
    return w
