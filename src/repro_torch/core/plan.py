"""SamplePlan: the metadata-only representation of a (sampled) operand.

A plan selects a subset of a BlockCOO's tiles (by index into ``blocks``),
sorted by row block, padded to a bucketed length with entries pointing at
the zero sentinel tile. Every row block appears at least once (a sentinel
entry for an otherwise-empty row), so every output tile is written.
Slicing the sparse matrix (paper Fig. 5) is an O(S) int32 rewrite; tile
data never moves.

``build_plan`` / ``full_plan`` are a copy of ``repro.core.plan``'s host
logic (bit-identical id lists); the plan's four arrays are uploaded to the
device once, when the plan is built.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.bcoo import BlockMeta, host_row_ptr


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


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

    def flops(self, bm: int, bk: int, d: int) -> int:
        """FLOPs of SpMM under this plan (Eq. 4b cost, block units)."""
        return 2 * self.n_active * bm * bk * d

    def bytes_moved(self, bm: int, bk: int, d: int) -> int:
        """f32 bytes an SpMM under this plan streams per call: each active
        tile plus the (bk, d) dense slab it gathers (output writes are
        plan-independent and excluded)."""
        return self.n_active * (bm * bk + bk * d) * 4


def plan_row_ptr(row_ids: torch.Tensor, n_row_blocks: int) -> torch.Tensor:
    """Recover the tiles-per-row-block pointer array from sorted row ids,
    on the ids' device."""
    bounds = torch.arange(n_row_blocks + 1, dtype=row_ids.dtype,
                          device=row_ids.device)
    return torch.searchsorted(row_ids.contiguous(), bounds,
                              side="left").to(torch.int32)


def build_plan(
    meta: BlockMeta,
    keep_col_blocks: np.ndarray | None,
    n_row_blocks: int,
    sentinel: int,
    bucket: int = 1,
    *,
    device: str | torch.device = "cuda",
) -> SamplePlan:
    """Build a plan keeping tiles whose column block is in ``keep_col_blocks``.

    keep_col_blocks: bool (n_col_blocks,) or None for the full/exact plan.
    sentinel: index of the zero tile (== s_total).
    bucket: pad s_pad up to a multiple of this; the padding is sentinel
    entries on the last row block's segment.
    device: where the plan's arrays live (uploaded here, once).
    """
    s_total = meta.row_ids.shape[0]
    if keep_col_blocks is None:
        keep_tile = np.ones(s_total, dtype=bool)
    else:
        keep_tile = keep_col_blocks[meta.col_ids]

    sel = np.nonzero(keep_tile)[0].astype(np.int32)
    rows = meta.row_ids[sel]
    cols = meta.col_ids[sel]

    # Guarantee every row block appears: add one sentinel entry per missing
    # row so the kernel zero-initializes that output tile.
    present = np.zeros(n_row_blocks, dtype=bool)
    present[rows] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    if missing.size:
        sel = np.concatenate([sel, np.full(missing.shape, sentinel, np.int32)])
        rows = np.concatenate([rows, missing])
        cols = np.concatenate([cols, np.zeros(missing.shape, np.int32)])

    order = np.argsort(rows, kind="stable")
    sel, rows, cols = sel[order], rows[order], cols[order]

    n_entries = int(sel.shape[0])
    s_pad = _ceil_to(max(n_entries, 1), max(bucket, 1))
    pad = s_pad - n_entries
    if pad:
        last_row = rows[-1] if n_entries else 0
        sel = np.concatenate([sel, np.full(pad, sentinel, np.int32)])
        rows = np.concatenate([rows, np.full(pad, last_row, np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, np.int32)])

    row_ptr = host_row_ptr(rows, n_row_blocks)

    def up(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    return SamplePlan(
        sel=up(sel), row_ids=up(rows), col_ids=up(cols), s_pad=s_pad,
        n_active=int(np.count_nonzero(keep_tile)), row_ptr=up(row_ptr))


def full_plan(meta: BlockMeta, n_row_blocks: int, sentinel: int,
              bucket: int = 1, *,
              device: str | torch.device = "cuda") -> SamplePlan:
    """The exact (un-sampled) plan."""
    return build_plan(meta, None, n_row_blocks, sentinel, bucket=bucket,
                      device=device)
