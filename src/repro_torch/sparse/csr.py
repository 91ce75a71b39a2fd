"""Host-side CSR container (numpy), the construction and IO format.

A copy of ``repro.sparse.csr``: the same arrays in the same order, so the
port's graphs, operands and tilings are bit-identical to the reference's.
Device compute uses the block-COO tiling in ``repro_torch.sparse.bcoo``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed Sparse Row matrix (host / numpy).

    rowptr: (n_rows + 1,) int64 — row i occupies [rowptr[i], rowptr[i+1]).
    col:    (nnz,) int32 column indices, sorted within each row.
    val:    (nnz,) float values.
    shape:  (n_rows, n_cols).
    """

    rowptr: np.ndarray
    col: np.ndarray
    val: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def row_nnz(self) -> np.ndarray:
        """#nnz per row — the paper's #nnz_i (for A^T, per Eq. 4b)."""
        return np.diff(self.rowptr).astype(np.int64)

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: tuple[int, int]) -> "CSR":
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        rowptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(rowptr, rows + 1, 1)
        rowptr = np.cumsum(rowptr)
        return CSR(rowptr=rowptr, col=cols.astype(np.int32),
                   val=vals.astype(np.float32), shape=shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        for i in range(self.n_rows):
            lo, hi = self.rowptr[i], self.rowptr[i + 1]
            out[i, self.col[lo:hi]] = self.val[lo:hi]
        return out

    def transpose(self) -> "CSR":
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64),
                         self.row_nnz())
        return CSR.from_coo(self.col.astype(np.int64), rows, self.val,
                            (self.n_cols, self.n_rows))

    def permute(self, perm: np.ndarray) -> "CSR":
        """Symmetric relabeling: row/col i -> position of i under ``perm``.

        ``perm[new] = old`` (i.e. ``perm`` lists old ids in new order).
        """
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64),
                         self.row_nnz())
        return CSR.from_coo(inv[rows], inv[self.col].astype(np.int64),
                            self.val, self.shape)

    def column_norms(self) -> np.ndarray:
        """L2 norm of every column — ‖A_{:,i}‖₂ in Eq. 3 (host precompute)."""
        out = np.zeros(self.n_cols, dtype=np.float64)
        np.add.at(out, self.col, self.val.astype(np.float64) ** 2)
        return np.sqrt(out).astype(np.float32)

    def column_nnz(self) -> np.ndarray:
        out = np.zeros(self.n_cols, dtype=np.int64)
        np.add.at(out, self.col, 1)
        return out
