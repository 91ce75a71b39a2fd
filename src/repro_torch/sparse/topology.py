"""Graph topology ops: normalizations used by the paper's models.

* GCN:        Ã = D̃^{-1/2} (A + I) D̃^{-1/2}      (Kipf & Welling, Eq. 1)
* GraphSAGE:  SpMM_MEAN(A, H) = D^{-1} A H        (paper App. A.3)

A copy of ``repro.sparse.topology`` (host numpy, bit-identical results).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.csr import CSR


def degrees(adj: CSR) -> np.ndarray:
    """Out-degree per row (== in-degree for undirected graphs)."""
    return adj.row_nnz()


def add_self_loops(adj: CSR) -> CSR:
    rows = np.repeat(np.arange(adj.n_rows, dtype=np.int64), adj.row_nnz())
    loop = np.arange(adj.n_rows, dtype=np.int64)
    return CSR.from_coo(
        np.concatenate([rows, loop]),
        np.concatenate([adj.col.astype(np.int64), loop]),
        np.concatenate([adj.val, np.ones(adj.n_rows, dtype=np.float32)]),
        adj.shape,
    )


def sym_normalize(adj: CSR, self_loops: bool = True) -> CSR:
    """Ã = D̃^{-1/2} (A + I) D̃^{-1/2} — the GCN propagation matrix."""
    a = add_self_loops(adj) if self_loops else adj
    # D̃ from row sums of values (weighted degree).
    deg = np.zeros(a.n_rows, dtype=np.float64)
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), a.row_nnz())
    np.add.at(deg, rows, a.val.astype(np.float64))
    dinv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    val = a.val * (dinv_sqrt[rows] * dinv_sqrt[a.col]).astype(np.float32)
    return CSR(rowptr=a.rowptr, col=a.col, val=val, shape=a.shape)


def mean_normalize(adj: CSR) -> CSR:
    """D^{-1} A — SpMM_MEAN as a plain SpMM (paper App. A.3).

    Folding D^{-1} into the values lets the MEAN aggregator reuse the very
    same bcoo_spmm kernel; the column norm of column j becomes
    degree-weighted, which the sampling scores then see.
    """
    deg = adj.row_nnz().astype(np.float64)
    rows = np.repeat(np.arange(adj.n_rows, dtype=np.int64), adj.row_nnz())
    dinv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    val = (adj.val.astype(np.float64) * dinv[rows]).astype(np.float32)
    return CSR(rowptr=adj.rowptr, col=adj.col, val=val, shape=adj.shape)
