"""Dense-lowering SpMM backend: a plan's tiles cast as one dense matmul.

The port of ``repro/kernels/dense_spmm.py``. On matmul hardware a sparse
operand of moderate density can be faster as a plain dense product than
through a gather-based sparse schedule ("Fast Training of Sparse Graph
Neural Networks on Dense Hardware"):

* :func:`dense_lowering` scatter-adds each tile of the plan into the dense
  ``(n_rb·bm, n_cb·bk)`` operand (every column block represented,
  untouched positions zero);
* :func:`dense_spmm` runs ``operand @ h`` as one ``torch.matmul`` with the
  fused ``bias`` / ``residual`` / ``relu`` epilogue of every backend.

The reference computes this with ``jnp.dot`` outside any Pallas kernel;
this is the backend a user picks with ``--backend dense``, never the
default, and not a port of ``bcoo_spmm``. The id-list convention is
``core.rsc_spmm``'s: sentinel entries point ``sel`` at the trailing
all-zero tile, entries whose row or column block lies out of range (the
``row_ids == n_row_blocks`` padding) are dropped, as the reference's
``mode="drop"`` scatter drops them, and duplicate ``(row, col)`` tiles
accumulate. The autograd of ``core.rsc_spmm`` wraps whichever backend
``spmm_apply`` runs, so ``rsc_spmm`` / ``exact_spmm`` take this one
unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import epilogue


def dense_lowering(
    blocks: torch.Tensor,   # (S+1, bm, bk) tiles incl. trailing zero sentinel
    sel: torch.Tensor,      # (s_pad,) int32
    row_ids: torch.Tensor,  # (s_pad,) int32
    col_ids: torch.Tensor,  # (s_pad,) int32
    *,
    n_row_blocks: int,
    n_col_blocks: int,
    bm: int,
    bk: int,
) -> torch.Tensor:
    """The plan's tiles as the dense ``(n_row_blocks·bm, n_col_blocks·bk)``
    f32 operand: scatter-ADD, so duplicated ids accumulate."""
    rows, cols = row_ids.long(), col_ids.long()
    keep = (rows >= 0) & (rows < n_row_blocks) & (cols >= 0) \
        & (cols < n_col_blocks)
    tiles = blocks[sel.long()[keep]].float()             # (k, bm, bk)
    dense = torch.zeros((n_row_blocks * n_col_blocks, bm, bk),
                        dtype=torch.float32, device=blocks.device)
    dense.index_add_(0, (rows * n_col_blocks + cols)[keep], tiles)
    # (n_rb, n_cb, bm, bk) -> (n_rb·bm, n_cb·bk), row-major
    return dense.reshape(n_row_blocks, n_col_blocks, bm, bk) \
        .permute(0, 2, 1, 3).reshape(n_row_blocks * bm, n_col_blocks * bk)


def dense_spmm(
    blocks: torch.Tensor,
    sel: torch.Tensor,
    row_ids: torch.Tensor,
    col_ids: torch.Tensor,
    h: torch.Tensor,        # (n_cols, d)
    *,
    n_row_blocks: int,
    bm: int,
    bk: int,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    relu: bool = False,
) -> torch.Tensor:
    """``epilogue(dense_lowering(plan) @ h)``: one matmul in f32, the
    epilogue ``relu(acc + bias + residual)``, the result in ``h``'s
    dtype."""
    n_cols = h.shape[0]
    if n_cols % bk:
        raise ValueError(f"h has {n_cols} rows, not a multiple of bk={bk}")
    a = dense_lowering(blocks, sel, row_ids, col_ids,
                       n_row_blocks=n_row_blocks, n_col_blocks=n_cols // bk,
                       bm=bm, bk=bk)
    return epilogue(torch.matmul(a, h.float()), bias, residual, relu,
                    h.dtype)
