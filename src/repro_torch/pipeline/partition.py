"""Row-block partitioning of a tiled operand for streaming inference.

``contiguous_block_partition`` is a copy of the reference's
(``repro/pipeline/partition.py``); the LDG partitioners and the subgraph
pool come with the minibatch port.
"""
from __future__ import annotations

import numpy as np


def contiguous_block_partition(
    row_ptr: np.ndarray,
    *,
    bm: int,
    bk: int,
    d: int,
    n_parts: int | None = None,
    budget_bytes: int | None = None,
) -> list[np.ndarray]:
    """Split row blocks of a tiled operand into contiguous partitions.

    Each partition's SpMM must fit the device-memory budget, estimated per
    row block ``r`` as tiles(r)·(bm·bk + bk·d)·4 bytes (the tiles plus a
    worst-case one-gathered-column-block-per-tile dense slab) plus the
    bm·d·4-byte output rows. ``n_parts`` overrides the budget with an even
    split. Returns a list of sorted row-block id arrays covering
    ``[0, n_row_blocks)``.
    """
    n_rb = row_ptr.shape[0] - 1
    if n_rb <= 0:
        return [np.arange(max(n_rb, 0), dtype=np.int64)]
    if n_parts is not None:
        n_parts = max(1, min(int(n_parts), n_rb))
        return [p.astype(np.int64) for p in
                np.array_split(np.arange(n_rb, dtype=np.int64), n_parts)]
    if budget_bytes is None:
        return [np.arange(n_rb, dtype=np.int64)]
    tiles = np.diff(row_ptr).astype(np.int64)
    cost = tiles * (bm * bk + bk * d) * 4 + bm * d * 4
    parts: list[np.ndarray] = []
    start, acc = 0, 0
    for r in range(n_rb):
        if r > start and acc + cost[r] > budget_bytes:
            parts.append(np.arange(start, r, dtype=np.int64))
            start, acc = r, 0
        acc += cost[r]
    parts.append(np.arange(start, n_rb, dtype=np.int64))
    return parts
