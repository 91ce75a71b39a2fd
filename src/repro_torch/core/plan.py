"""SamplePlan: the metadata-only representation of a (sampled) operand.

A plan selects a subset of a BlockCOO's tiles (by index into ``blocks``),
sorted by row block, padded with entries pointing at the zero sentinel
tile. Slicing the sparse matrix (paper Fig. 5) is an O(S) int32 rewrite;
tile data never moves.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """Index-list view of a (possibly sampled) BlockCOO operand.

    ``row_ptr`` is the CSR-of-tiles pointer array of the sorted id lists:
    tiles of output row block ``r`` occupy ``sel[row_ptr[r]:row_ptr[r+1]]``.
    It drives the row-segmented SpMM kernel; a plan may carry ``None``, and
    the kernel wrapper then recovers it with :func:`plan_row_ptr`.
    """

    sel: torch.Tensor      # (s_pad,) int32 — tile index; sentinel = s_total
    row_ids: torch.Tensor  # (s_pad,) int32 — sorted ascending
    col_ids: torch.Tensor  # (s_pad,) int32
    n_active: int          # real (non-sentinel) tiles — bookkeeping/FLOPs
    s_pad: int             # id-list length
    row_ptr: torch.Tensor | None = None  # (n_row_blocks + 1,) int32 or None


def plan_row_ptr(row_ids: torch.Tensor, n_row_blocks: int) -> torch.Tensor:
    """Recover the tiles-per-row-block pointer array from sorted row ids,
    on the ids' device."""
    bounds = torch.arange(n_row_blocks + 1, dtype=row_ids.dtype,
                          device=row_ids.device)
    return torch.searchsorted(row_ids.contiguous(), bounds,
                              side="left").to(torch.int32)
