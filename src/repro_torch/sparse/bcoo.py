"""Block-COO: the tiled sparse format the SpMM kernel consumes.

A sparse matrix is stored as a list of dense (bm, bk) tiles:

    blocks:  (S+1, bm, bk)  — value tiles; entry S is an all-zero SENTINEL
    row_ids: (S,) int32     — tile row-block coordinate, sorted ascending
    col_ids: (S,) int32     — tile column-block coordinate

Sampling never moves tile data: a sampled operand is a new index list into
``blocks`` (a ``SamplePlan``), with padding entries pointing at the sentinel.

The host side (``host_row_ptr``, ``BlockMeta``, ``HostBlockCOO`` with
``pad_to`` and ``replace_row_blocks``, ``pad_block_meta``,
``csr_to_bcoo_host``, ``retile_rows``, ``degree_sort_permutation``) is a
copy of ``repro.sparse.bcoo`` and yields bit-identical arrays. The device operand
``BlockCOO`` is a dataclass of torch tensors; ``csr_to_bcoo`` builds one on
the host, uploads it and keeps only the planner's ``BlockMeta``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.csr import CSR


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def host_row_ptr(row_ids: np.ndarray, n_row_blocks: int) -> np.ndarray:
    """CSR-of-tiles pointers from sorted row ids (host, O(n log s))."""
    return np.searchsorted(
        row_ids, np.arange(n_row_blocks + 1)).astype(np.int32)


def _expand_ranges(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Concatenate ``arange(starts[i], ends[i])`` without a Python loop."""
    counts = (ends - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    offs = np.repeat(np.cumsum(counts) - counts, counts)
    return np.repeat(starts.astype(np.int64), counts) \
        + (np.arange(total) - offs)


@dataclasses.dataclass(frozen=True)
class BlockCOO:
    """Device block-COO sparse matrix (torch tensors on one device).

    ``blocks`` has ``s_total + 1`` tiles; index ``s_total`` is the zero
    sentinel used by sampled plans for padding. ``row_ptr`` is the
    CSR-of-tiles pointer array: tiles of row block ``r`` are
    ``[row_ptr[r], row_ptr[r+1])`` in the sorted id lists. Id lists are
    int32, as in the reference; index sites cast them to int64.
    """

    blocks: torch.Tensor     # (s_total + 1, bm, bk)
    row_ids: torch.Tensor    # (s_total,) int32, sorted ascending
    col_ids: torch.Tensor    # (s_total,) int32
    bm: int
    bk: int
    n_rows: int              # padded logical row count (multiple of bm)
    n_cols: int              # padded logical col count (multiple of bk)
    n_row_blocks: int
    n_col_blocks: int
    s_total: int             # number of real (non-sentinel) tiles
    row_ptr: torch.Tensor | None = None  # (n_row_blocks + 1,) int32
    # (s_total,) int32 arange: the ``sel`` of the operand's exact plan,
    # made once with the operand
    tile_ids: torch.Tensor | None = None

    def nbytes(self) -> int:
        return self.blocks.numel() * self.blocks.element_size()


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    """Host-side planner metadata for one BlockCOO operand."""

    row_ids: np.ndarray          # (s_total,) int32, sorted by row
    col_ids: np.ndarray          # (s_total,) int32
    # tiles-per-column-block: the Eq. 4b cost unit (each tile costs
    # 2*bm*bk*d FLOPs in an SpMM against a (n_cols, d) dense operand).
    col_block_tiles: np.ndarray  # (n_col_blocks,) int64
    # Σ_{column i in block} ‖A_{:,i}‖₂  — the static half of Eq. 3 scores.
    col_block_norm: np.ndarray   # (n_col_blocks,) float32
    # per-column nnz — exact Eq. 4b cost for the reference (unblocked) path
    col_nnz: np.ndarray          # (n_cols_unpadded,) int64
    col_norm: np.ndarray         # (n_cols_unpadded,) float32


@dataclasses.dataclass(frozen=True)
class HostBlockCOO:
    """Host (numpy) mirror of :class:`BlockCOO`.

    ``blocks`` carries the trailing zero sentinel, exactly like the device
    layout; ``to_device`` is where host tiles cross to the card.
    """

    blocks: np.ndarray    # (s_total + 1, bm, bk) float32, incl. sentinel
    row_ids: np.ndarray   # (s_total,) int32, sorted ascending
    col_ids: np.ndarray   # (s_total,) int32
    bm: int
    bk: int
    n_rows: int
    n_cols: int
    n_row_blocks: int
    n_col_blocks: int
    s_total: int
    row_ptr: np.ndarray | None = None  # (n_row_blocks + 1,) int32

    def pad_to(self, n_blocks: int, s_pad: int) -> "HostBlockCOO":
        """Pad to a bucket shape: ``n_blocks`` row/col blocks (square
        operands only) and ``s_pad`` tiles.

        Pad tiles are zero and sit at the last row block so ``row_ids``
        stays sorted; they are no-ops under SpMM. Shape bucketing pads every
        subgraph of a bucket to one shape.
        """
        if n_blocks < self.n_row_blocks or s_pad < self.s_total:
            raise ValueError(
                f"bucket ({n_blocks} blocks, {s_pad} tiles) smaller than "
                f"operand ({self.n_row_blocks} blocks, {self.s_total} tiles)")
        if n_blocks == self.n_row_blocks and s_pad == self.s_total:
            return self
        if self.n_row_blocks != self.n_col_blocks:
            raise ValueError("pad_to supports square operands only")
        extra = s_pad - self.s_total
        blocks = np.zeros((s_pad + 1, self.bm, self.bk), dtype=np.float32)
        blocks[: self.s_total] = self.blocks[: self.s_total]
        row_ids = np.concatenate(
            [self.row_ids, np.full(extra, n_blocks - 1, np.int32)])
        col_ids = np.concatenate([self.col_ids, np.zeros(extra, np.int32)])
        return HostBlockCOO(
            blocks=blocks, row_ids=row_ids, col_ids=col_ids,
            bm=self.bm, bk=self.bk,
            n_rows=n_blocks * self.bm, n_cols=n_blocks * self.bk,
            n_row_blocks=n_blocks, n_col_blocks=n_blocks,
            s_total=s_pad,
            row_ptr=host_row_ptr(row_ids, n_blocks))

    def replace_row_blocks(self, rbs: np.ndarray, row_ids: np.ndarray,
                           col_ids: np.ndarray, blocks: np.ndarray,
                           in_place: bool = True) -> "HostBlockCOO":
        """Splice replacement tiles for the row blocks ``rbs`` into the
        tile lists, leaving every other row block's tiles untouched.

        ``row_ids``/``col_ids``/``blocks`` are the NEW tiles of exactly
        those row blocks, sorted by (row block, col block) — the order
        ``csr_to_bcoo_host`` produces. When every replaced block keeps its
        tile count, the swap is a dirty-bounded in-place write into this
        object's arrays (callers sharing the arrays must hold their own
        copies); when counts change, a new ``HostBlockCOO`` is built by a
        splice that re-sorts the tile lists (O(s_total) memcpy, still far
        cheaper than the O(nnz) scatter of a full re-tile).
        """
        rbs = np.asarray(rbs, dtype=np.int64)
        ptr = (self.row_ptr if self.row_ptr is not None
               else host_row_ptr(self.row_ids, self.n_row_blocks))
        old_idx = _expand_ranges(ptr[rbs], ptr[rbs + 1])
        old_counts = (ptr[rbs + 1] - ptr[rbs]).astype(np.int64)
        new_counts = (np.searchsorted(row_ids, rbs + 1)
                      - np.searchsorted(row_ids, rbs))
        if new_counts.sum() != row_ids.shape[0]:
            raise ValueError("replacement tiles reference row blocks "
                             "outside the replaced set")
        if in_place and np.array_equal(old_counts, new_counts):
            # value/column rewrite only: positions and row ids unchanged
            self.blocks[old_idx] = blocks
            self.col_ids[old_idx] = col_ids
            return self
        keep = np.ones(self.s_total, dtype=bool)
        keep[old_idx] = False
        all_rows = np.concatenate([self.row_ids[keep],
                                   row_ids.astype(np.int32)])
        all_cols = np.concatenate([self.col_ids[keep],
                                   col_ids.astype(np.int32)])
        order = np.lexsort((all_cols, all_rows))
        s_new = int(all_rows.shape[0])
        out = np.zeros((s_new + 1, self.bm, self.bk), dtype=np.float32)
        out[:s_new] = np.concatenate(
            [self.blocks[: self.s_total][keep], blocks], axis=0)[order]
        row_ids2 = all_rows[order]
        return HostBlockCOO(
            blocks=out, row_ids=row_ids2, col_ids=all_cols[order],
            bm=self.bm, bk=self.bk,
            n_rows=self.n_rows, n_cols=self.n_cols,
            n_row_blocks=self.n_row_blocks, n_col_blocks=self.n_col_blocks,
            s_total=s_new,
            row_ptr=host_row_ptr(row_ids2, self.n_row_blocks))

    def to_device(self, device: str | torch.device,
                  dtype: torch.dtype = torch.float32) -> BlockCOO:
        row_ptr = (self.row_ptr if self.row_ptr is not None
                   else host_row_ptr(self.row_ids, self.n_row_blocks))
        return BlockCOO(
            blocks=torch.as_tensor(self.blocks).to(device=device,
                                                   dtype=dtype),
            row_ids=torch.as_tensor(self.row_ids).to(device),
            col_ids=torch.as_tensor(self.col_ids).to(device),
            bm=self.bm, bk=self.bk,
            n_rows=self.n_rows, n_cols=self.n_cols,
            n_row_blocks=self.n_row_blocks, n_col_blocks=self.n_col_blocks,
            s_total=self.s_total,
            row_ptr=torch.as_tensor(row_ptr).to(device),
            tile_ids=torch.arange(self.s_total, dtype=torch.int32,
                                  device=device))

    def nbytes(self) -> int:
        return self.blocks.nbytes


def pad_block_meta(meta: BlockMeta, n_col_blocks: int) -> BlockMeta:
    """Extend planner metadata to a bucket-padded column-block count.

    Padding blocks carry zero tiles and zero norms: the allocator treats
    them as free zero-score columns and never selects them.
    """
    cur = meta.col_block_tiles.shape[0]
    if n_col_blocks == cur:
        return meta
    if n_col_blocks < cur:
        raise ValueError(f"cannot shrink meta from {cur} to {n_col_blocks}")
    extra = n_col_blocks - cur
    return BlockMeta(
        row_ids=meta.row_ids, col_ids=meta.col_ids,
        col_block_tiles=np.pad(meta.col_block_tiles, (0, extra)),
        col_block_norm=np.pad(meta.col_block_norm, (0, extra)),
        col_nnz=meta.col_nnz, col_norm=meta.col_norm)


def degree_sort_permutation(adj: CSR) -> np.ndarray:
    """Relabel nodes by descending degree.

    Returns ``perm`` with ``perm[new] = old``. Degree-sorted labeling makes
    128-wide column blocks degree-homogeneous, so block-granular top-k
    approximates per-column top-k well.
    """
    deg = adj.row_nnz()
    # stable sort for determinism
    return np.argsort(-deg, kind="stable").astype(np.int64)


def csr_to_bcoo_host(
    csr: CSR,
    bm: int = 128,
    bk: int = 128,
) -> tuple[HostBlockCOO, BlockMeta]:
    """Convert host CSR to host block-COO + planner metadata (no device)."""
    n_rows_p = _ceil_to(max(csr.n_rows, 1), bm)
    n_cols_p = _ceil_to(max(csr.n_cols, 1), bk)
    n_rb, n_cb = n_rows_p // bm, n_cols_p // bk

    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), csr.row_nnz())
    cols = csr.col.astype(np.int64)
    rb, cb = rows // bm, cols // bk
    key = rb * n_cb + cb
    uniq, inverse = np.unique(key, return_inverse=True)
    s_total = int(uniq.shape[0])

    blocks = np.zeros((s_total + 1, bm, bk), dtype=np.float32)
    np.add.at(blocks, (inverse, rows % bm, cols % bk), csr.val)

    u_rb = (uniq // n_cb).astype(np.int32)
    u_cb = (uniq % n_cb).astype(np.int32)
    # np.unique returns sorted keys => already sorted by (row_block, col_block)

    col_block_tiles = np.zeros(n_cb, dtype=np.int64)
    np.add.at(col_block_tiles, u_cb, 1)

    col_norm = csr.column_norms()
    col_nnz = csr.column_nnz()
    cb_of_col = np.arange(csr.n_cols) // bk
    col_block_norm = np.zeros(n_cb, dtype=np.float64)
    np.add.at(col_block_norm, cb_of_col, col_norm.astype(np.float64))

    host = HostBlockCOO(
        blocks=blocks, row_ids=u_rb, col_ids=u_cb,
        bm=bm, bk=bk,
        n_rows=n_rows_p, n_cols=n_cols_p,
        n_row_blocks=n_rb, n_col_blocks=n_cb,
        s_total=s_total,
        row_ptr=host_row_ptr(u_rb, n_rb),
    )
    meta = BlockMeta(
        row_ids=u_rb, col_ids=u_cb,
        col_block_tiles=col_block_tiles,
        col_block_norm=col_block_norm.astype(np.float32),
        col_nnz=col_nnz, col_norm=col_norm,
    )
    return host, meta


def retile_rows(
    host: HostBlockCOO,
    meta: BlockMeta,
    csr: CSR,
    dirty_rows: np.ndarray,
    in_place: bool = True,
) -> tuple[HostBlockCOO, BlockMeta]:
    """Dirty-bounded incremental re-tile: rebuild only the row blocks
    touched by ``dirty_rows`` from the (already updated) ``csr``.

    ``host``/``meta`` must have been built (by ``csr_to_bcoo_host`` or a
    previous ``retile_rows``) from a CSR that differs from ``csr`` ONLY in
    rows covered by ``dirty_rows`` — rows outside the dirty row blocks are
    trusted unchanged and their tiles are not reread. The scatter into
    tiles, the dominant cost of a full re-tile, runs over the dirty rows'
    nnz only; the result is bit-identical to ``csr_to_bcoo_host(csr)`` for
    the tile arrays (planner norms drift by float addition order in the
    touched columns, and ``col_nnz`` is exact provided the CSR carries no
    duplicate entries or explicit zeros — true of the normalized
    propagation operands).

    With ``in_place`` (default), count-preserving updates write straight
    into ``host``'s arrays — callers sharing those arrays across replicas
    must pass copies or ``in_place=False``.
    """
    bm, bk = host.bm, host.bk
    n_cb = host.n_col_blocks
    rbs = np.unique(np.asarray(dirty_rows, dtype=np.int64) // bm)
    if rbs.size == 0:
        return host, meta

    # new tiles of the dirty row blocks, from the updated CSR
    rows = (rbs[:, None] * bm + np.arange(bm)[None, :]).reshape(-1)
    rows = rows[rows < csr.n_rows]
    idx = _expand_ranges(csr.rowptr[rows], csr.rowptr[rows + 1])
    e_rows = np.repeat(rows, (csr.rowptr[rows + 1]
                              - csr.rowptr[rows]).astype(np.int64))
    e_cols = csr.col[idx].astype(np.int64)
    e_vals = csr.val[idx]
    key = (e_rows // bm) * n_cb + (e_cols // bk)
    uniq, inverse = np.unique(key, return_inverse=True)
    k = int(uniq.shape[0])
    new_blocks = np.zeros((k, bm, bk), dtype=np.float32)
    np.add.at(new_blocks, (inverse, e_rows % bm, e_cols % bk), e_vals)
    new_rb = (uniq // n_cb).astype(np.int32)
    new_cb = (uniq % n_cb).astype(np.int32)

    # planner-metadata deltas: subtract the replaced tiles' per-column
    # contributions (tile granularity), add the new CSR entries'
    ptr = (host.row_ptr if host.row_ptr is not None
           else host_row_ptr(host.row_ids, host.n_row_blocks))
    old_idx = _expand_ranges(ptr[rbs], ptr[rbs + 1])
    n_cols_u = meta.col_norm.shape[0]
    sq = meta.col_norm.astype(np.float64) ** 2
    nnz = meta.col_nnz.copy()
    if old_idx.size:
        contrib = (host.blocks[old_idx].astype(np.float64) ** 2).sum(axis=1)
        cnt = (host.blocks[old_idx] != 0).sum(axis=1)
        cols_of = (host.col_ids[old_idx].astype(np.int64)[:, None] * bk
                   + np.arange(bk)[None, :]).reshape(-1)
        m = cols_of < n_cols_u
        np.subtract.at(sq, cols_of[m], contrib.reshape(-1)[m])
        np.subtract.at(nnz, cols_of[m], cnt.reshape(-1)[m])
    if e_cols.size:
        np.add.at(sq, e_cols, e_vals.astype(np.float64) ** 2)
        np.add.at(nnz, e_cols, 1)
    col_norm = np.sqrt(np.maximum(sq, 0.0)).astype(np.float32)

    host = host.replace_row_blocks(rbs, new_rb, new_cb, new_blocks,
                                   in_place=in_place)
    cb_norm = np.zeros(n_cb, dtype=np.float64)
    np.add.at(cb_norm, np.arange(n_cols_u) // bk,
              col_norm.astype(np.float64))
    meta = BlockMeta(
        row_ids=host.row_ids, col_ids=host.col_ids,
        col_block_tiles=np.bincount(host.col_ids,
                                    minlength=n_cb).astype(np.int64),
        col_block_norm=cb_norm.astype(np.float32),
        col_nnz=nnz, col_norm=col_norm)
    return host, meta


def csr_to_bcoo(
    csr: CSR,
    bm: int = 128,
    bk: int = 128,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> tuple[BlockCOO, BlockMeta]:
    """Host CSR → device block-COO + its host planner metadata.

    The dense host tiles (``(s_total + 1) · bm · bk`` floats, 2.2 GB for
    Reddit at ``--scale 0.1``) live only until the upload: build operands
    one at a time so one host copy exists at once."""
    host, meta = csr_to_bcoo_host(csr, bm, bk)
    return host.to_device(device, dtype), meta
