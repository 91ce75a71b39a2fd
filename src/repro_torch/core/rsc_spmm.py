"""Block-COO SpMM apply with the fused epilogue (forward only).

``spmm_apply`` is the one entry every SpMM of the port goes through:

    out[r] = epilogue(Σ_{tiles (r, c) in plan} blocks[sel] @ h[c·bk:(c+1)·bk])
    epilogue(y) = max(y + bias + residual, 0) if relu else y + bias + residual

Backends:

* ``"kernel"`` — ``repro_torch.kernels.ops.bcoo_spmm``: on a CUDA tensor
  the hand-written CUDA kernel (it launches or raises); on a CPU tensor its
  plain PyTorch version.
* ``"ref"`` — CPU tensors only: the chunked streaming schedule of the
  reference's ``spmm_stream`` (``repro/core/rsc_spmm.py``), with
  ``index_add_`` for the scatter.

The autograd Functions (``rsc_spmm``, ``exact_spmm``: exact forward,
sampled backward) come with the training port.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import SamplePlan
from repro_torch.sparse.bcoo import BlockCOO

DEFAULT_CHUNK = 32


def exact_plan(a: BlockCOO) -> SamplePlan:
    """The identity plan of a BlockCOO: its own sorted id lists."""
    return SamplePlan(
        sel=torch.arange(a.s_total, dtype=torch.int32,
                         device=a.blocks.device),
        row_ids=a.row_ids, col_ids=a.col_ids,
        s_pad=a.s_total, n_active=a.s_total, row_ptr=a.row_ptr)


def spmm_stream(
    blocks: torch.Tensor,   # (S+1, bm, bk) tiles incl. trailing zero sentinel
    sel: torch.Tensor,      # (s_pad,) int32
    row_ids: torch.Tensor,  # (s_pad,) int32, sorted ascending
    col_ids: torch.Tensor,  # (s_pad,) int32
    h: torch.Tensor,        # (n_cols, d)
    *,
    n_row_blocks: int,
    bm: int,
    bk: int,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Streaming SpMM over ``chunk``-tile slices of the id lists.

    Each step gathers ``(chunk, bm, bk)`` tiles and ``(chunk, bk, d)``
    slabs, contracts them in f32 and ``index_add_``s into the
    ``(n_row_blocks, bm, d)`` accumulator; the ``(s_pad, bm, d)`` partial
    products are never materialized. Row ids outside ``[0, n_row_blocks)``
    are dropped, as the reference's ``mode="drop"`` scatter drops them.
    """
    d = h.shape[-1]
    s_pad = sel.shape[0]
    chunk = max(1, min(chunk, s_pad))
    hb = h.reshape(-1, bk, d)
    acc = torch.zeros((n_row_blocks, bm, d), dtype=torch.float32,
                      device=h.device)
    for lo in range(0, s_pad, chunk):
        rows = row_ids[lo:lo + chunk].long()
        part = torch.einsum("sij,sjd->sid",
                            blocks[sel[lo:lo + chunk].long()].float(),
                            hb[col_ids[lo:lo + chunk].long()].float())
        keep = (rows >= 0) & (rows < n_row_blocks)
        acc.index_add_(0, rows[keep], part[keep])
    return acc.reshape(n_row_blocks * bm, d).to(h.dtype)


def spmm_apply(
    blocks: torch.Tensor,   # (S+1, bm, bk) tiles incl. sentinel
    plan: SamplePlan,
    h: torch.Tensor,        # (n_cols, d)
    n_row_blocks: int,
    bm: int,
    bk: int,
    backend: str = "kernel",
    *,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    relu: bool = False,
    chunk: int | None = None,
) -> torch.Tensor:
    """out[r] = epilogue(Σ_{tiles (r,c) in plan} blocks[sel] @ h[c·bk:...]).

    The epilogue contract is the same on both backends (see the module
    docstring). ``chunk`` tunes the ``"ref"`` schedule only.
    """
    if backend == "kernel":
        from repro_torch.kernels import ops as kops
        return kops.bcoo_spmm(
            blocks, plan.sel, plan.row_ids, plan.col_ids, h,
            n_row_blocks=n_row_blocks, bm=bm, bk=bk, row_ptr=plan.row_ptr,
            bias=bias, residual=residual, relu=relu)
    if backend != "ref":
        raise ValueError(f"unknown SpMM backend {backend!r} "
                         "(expected 'kernel' or 'ref')")
    if h.device.type != "cpu":
        raise ValueError(f"backend 'ref' runs CPU tensors only, got "
                         f"{h.device}; use backend 'kernel' on the card")
    out = spmm_stream(blocks, plan.sel, plan.row_ids, plan.col_ids, h,
                      n_row_blocks=n_row_blocks, bm=bm, bk=bk,
                      chunk=chunk if chunk is not None else DEFAULT_CHUNK)
    if bias is not None:
        out = out + bias
    if residual is not None:
        out = out + residual
    if relu:
        out = torch.relu(out)
    return out
