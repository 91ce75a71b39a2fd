"""Plain PyTorch versions of the hand-written kernels.

They compute what the kernels compute, on any device, and are what a
kernel wrapper runs for a tensor that lies on the CPU. The tests hold them
against ``repro.kernels.ref``; ``chip_smoke.py`` holds the kernels against
them on the card.
"""
from __future__ import annotations

import torch


def epilogue(acc: torch.Tensor, bias: torch.Tensor | None,
             residual: torch.Tensor | None, relu: bool,
             dtype: torch.dtype) -> torch.Tensor:
    """``relu(acc + bias + residual)`` in f32, cast to ``dtype`` — the
    fused epilogue of the SpMM kernel."""
    y = acc.float()
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(dtype)


def bcoo_spmm_ref(
    blocks: torch.Tensor,   # (S+1, bm, bk)
    sel: torch.Tensor,      # (s_pad,)
    row_ids: torch.Tensor,  # (s_pad,)
    col_ids: torch.Tensor,  # (s_pad,)
    h: torch.Tensor,        # (n_cols, d)
    *,
    n_row_blocks: int,
    bm: int,
    bk: int,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    relu: bool = False,
) -> torch.Tensor:
    """``out[r] = Σ_{s: row_ids[s]==r} blocks[sel[s]] @ h[col_ids[s]]``.

    Products and sums in f32, result in ``h``'s dtype. Entries whose row id
    lies outside ``[0, n_row_blocks)`` are dropped, as ``segment_sum`` drops
    them in the reference (``index_add_`` would raise). With any of
    ``bias``/``residual``/``relu`` the kernel's epilogue is applied to the
    f32 sums before the cast.
    """
    d = h.shape[-1]
    hb = h.reshape(-1, bk, d)
    tiles = blocks[sel.long()].float()                   # (s_pad, bm, bk)
    gathered = hb[col_ids.long()].float()                # (s_pad, bk, d)
    part = torch.einsum("sij,sjd->sid", tiles, gathered)
    rows = row_ids.long()
    keep = (rows >= 0) & (rows < n_row_blocks)
    acc = torch.zeros((n_row_blocks, bm, d), dtype=torch.float32,
                      device=h.device)
    acc.index_add_(0, rows[keep], part[keep])
    acc = acc.reshape(n_row_blocks * bm, d)
    if bias is None and residual is None and not relu:
        return acc.to(h.dtype)
    return epilogue(acc, bias, residual, relu, h.dtype)
