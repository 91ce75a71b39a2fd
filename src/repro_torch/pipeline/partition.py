"""Offline subgraph pool construction with shape bucketing, and row-block
partitioning for streaming inference.

A copy of ``repro.pipeline.partition``'s host logic (bit-identical pools).
Per the paper's GraphSAINT setting (§3.3.1, footnote 1), subgraphs are
sampled OFFLINE before training; each carries its own cached RSC plans
across the epochs it reappears in. ``build_pool`` builds that pool:

* ``random_walk`` — the GraphSAINT-RW sampler (roots × walk length),
  overlapping subgraphs, the paper's Table 3 configuration;
* ``ldg`` — streaming Linear Deterministic Greedy edge-cut partitioning
  (Stanton & Kliot 2012), disjoint node parts that jointly cover the graph
  (so one pass over the pool touches every training node exactly once).

Shape bucketing: each subgraph pads its operands to one of at most
``n_buckets`` (node-block, tile) shapes, so every subgraph of a bucket
shares one SpMM signature (one autotune decision, one ``plan_pad``).
Operands stay on the HOST (``HostBlockCOO``) — the prefetcher owns the
device uploads.

``contiguous_block_partition`` splits an operand's row blocks for the
streaming forward (``infer/stream.py``) by a device-memory budget;
``ldg_block_partition`` groups them by tile connectivity instead (the
streaming engine's ``partition_method="ldg"``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.saint import (SaintCoefficients, induced_subgraph,
                                      random_walk_subgraph,
                                      saint_coefficients)
from repro_torch.graphs.synthetic import GraphData
from repro_torch.models.gnn.common import (degree_sorted_arrays,
                                           pad_node_arrays)
from repro_torch.sparse.bcoo import (BlockMeta, HostBlockCOO,
                                     csr_to_bcoo_host, pad_block_meta)
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.topology import mean_normalize, sym_normalize


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    n_subgraphs: int = 8
    method: str = "random_walk"      # or "ldg"
    roots: int = 200                 # random-walk roots per subgraph
    walk_length: int = 4
    n_buckets: int = 2               # max distinct operand shapes
    block: int = 32                  # bm == bk
    degree_sort: bool = True
    seed: int = 0
    # GraphSAINT bias correction (loss λ_v + aggregator α_{u,v} weights from
    # exact pool appearance counts). Identity for disjoint ``ldg`` pools.
    saint_norm: bool = True


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One padded operand shape shared by a group of subgraphs."""

    n_blocks: int       # node blocks (rows == cols; square operands)
    s_pad: int          # tiles per operand
    plan_pad: int       # fixed SamplePlan length (covers full plan + one
                        # sentinel per row block, any allocation fits)


@dataclasses.dataclass
class HostSubgraph:
    """One pool entry: bucket-padded host operands + planner metadata."""

    sub_id: int
    bucket_id: int
    nodes: np.ndarray          # parent-graph node id per local row (post
                               # degree-sort order, length n_valid)
    n_valid: int               # real node count (rest is padding)
    prop: HostBlockCOO         # forward operand (Ã or D⁻¹A), bucket-padded
    prop_t: HostBlockCOO       # pre-transposed backward operand
    meta: BlockMeta            # planner metadata of prop_t (un-padded)
    fro: float                 # ‖operand‖_F (Eq. 4a static half)
    features: np.ndarray       # (n_pad, d_in) f32
    labels: np.ndarray         # (n_pad,) int32 | (n_pad, C) f32
    train_mask: np.ndarray     # (n_pad,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    loss_w: np.ndarray | None = None   # (n_pad,) f32 GraphSAINT 1/λ_v

    def nbytes(self) -> int:
        return (self.prop.nbytes() + self.prop_t.nbytes()
                + self.features.nbytes)


@dataclasses.dataclass
class SubgraphPool:
    subgraphs: list[HostSubgraph]
    buckets: list[Bucket]
    num_classes: int
    multilabel: bool
    feat_dim: int
    mean_agg: bool             # operands are D⁻¹A (GraphSAGE) vs Ã
    block: int
    # Parent-graph arrays for deduplicated pooled evaluation (nodes shared
    # by overlapping subgraphs are scored once, not once per appearance).
    n_nodes: int = 0
    node_labels: np.ndarray | None = None
    node_val_mask: np.ndarray | None = None
    node_test_mask: np.ndarray | None = None
    saint: SaintCoefficients | None = None

    def __len__(self) -> int:
        return len(self.subgraphs)


def ldg_partition(adj: CSR, n_parts: int,
                  rng: np.random.Generator) -> list[np.ndarray]:
    """Streaming Linear Deterministic Greedy node partitioning.

    Nodes stream in random order; each goes to the part holding most of its
    already-placed neighbors, damped by fullness (score = |N(v) ∩ P| ·
    (1 − |P|/cap)), ties to the least-loaded part. One O(E) pass.
    """
    n = adj.n_rows
    if n_parts <= 1:
        return [np.arange(n, dtype=np.int64)]
    cap = -(-n // n_parts)        # ceil: hard per-part capacity
    part = np.full(n, -1, dtype=np.int64)
    sizes = np.zeros(n_parts, dtype=np.int64)
    for u in rng.permutation(n):
        nbrs = adj.col[adj.rowptr[u]:adj.rowptr[u + 1]]
        placed = part[nbrs]
        placed = placed[placed >= 0]
        cnt = np.bincount(placed, minlength=n_parts).astype(np.float64)
        score = cnt * (1.0 - sizes / cap)
        score[sizes >= cap] = -np.inf
        best = int(np.argmax(score))
        if score[best] <= 0.0:    # no placed neighbors: least-loaded part
            open_parts = np.nonzero(sizes < cap)[0]
            best = int(open_parts[np.argmin(sizes[open_parts])])
        part[u] = best
        sizes[best] += 1
    return [np.nonzero(part == i)[0].astype(np.int64)
            for i in range(n_parts) if (part == i).any()]


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


def ldg_block_partition(row_ids: np.ndarray, col_ids: np.ndarray,
                        n_blocks: int, n_parts: int,
                        seed: int = 0) -> list[np.ndarray]:
    """LDG partition of ROW BLOCKS by tile connectivity.

    Builds the block-level connectivity graph (row block r ~ col block c
    whenever a tile (r, c) exists, symmetrized) and reuses
    :func:`ldg_partition` on it, so row blocks that share column blocks land
    in the same partition — fewer distinct column blocks to gather per
    streaming-inference partition. Partitions come back sorted.
    """
    if n_parts <= 1 or n_blocks <= 1:
        return [np.arange(n_blocks, dtype=np.int64)]
    rows = np.concatenate([row_ids.astype(np.int64),
                           col_ids.astype(np.int64)])
    cols = np.concatenate([col_ids.astype(np.int64),
                           row_ids.astype(np.int64)])
    keep = rows != cols            # self-edges carry no grouping signal
    key = rows * n_blocks + cols
    _, idx = np.unique(key, return_index=True)
    idx = idx[keep[idx]]
    adj = CSR.from_coo(rows[idx], cols[idx],
                       np.ones(idx.shape[0], np.float32),
                       (n_blocks, n_blocks))
    parts = ldg_partition(adj, n_parts, np.random.default_rng(seed))
    return [np.sort(p) for p in parts]


def make_buckets(shapes: list[tuple[int, int]],
                 n_buckets: int) -> tuple[list[Bucket], np.ndarray]:
    """Group subgraph shapes into ≤ n_buckets padded shapes.

    shapes: per subgraph (n_blocks, s_total). Subgraphs are sorted by size
    and cut into contiguous groups; each group's bucket is the max over both
    dims, so padding waste stays small when sizes are homogeneous.
    Returns (buckets, bucket_id per subgraph).
    """
    n = len(shapes)
    n_buckets = max(1, min(n_buckets, n))
    order = np.argsort([nb * (10 ** 9) + s for nb, s in shapes])
    assign = np.zeros(n, dtype=np.int64)
    raw: list[tuple[int, int]] = []
    bounds = np.linspace(0, n, n_buckets + 1).astype(int)
    for b in range(n_buckets):
        grp = order[bounds[b]:bounds[b + 1]]
        if grp.size == 0:
            continue
        nb = max(shapes[i][0] for i in grp)
        sp = max(shapes[i][1] for i in grp)
        if raw and raw[-1] == (nb, sp):        # dedupe identical buckets
            bid = len(raw) - 1
        else:
            raw.append((nb, sp))
            bid = len(raw) - 1
        assign[grp] = bid
    buckets = [Bucket(n_blocks=nb, s_pad=sp, plan_pad=sp + nb)
               for nb, sp in raw]
    return buckets, assign


def build_pool(g: GraphData, cfg: PoolConfig,
               mean_agg: bool = False) -> SubgraphPool:
    """Sample/partition ``g`` into a bucket-padded host subgraph pool."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.method == "random_walk":
        subs = [random_walk_subgraph(g, cfg.roots, cfg.walk_length, rng)
                for _ in range(cfg.n_subgraphs)]
    elif cfg.method == "ldg":
        parts = ldg_partition(g.adj, cfg.n_subgraphs, rng)
        subs = [induced_subgraph(g, nodes) for nodes in parts]
    else:
        raise ValueError(f"unknown pool method {cfg.method!r}")

    # GraphSAINT bias correction: exact pool appearance counts. For
    # disjoint ``ldg`` partitions both corrections are identities (every
    # node/edge appears exactly once), so nothing changes there.
    coeffs = saint_coefficients(subs, g.n) if cfg.saint_norm else None

    normalize = mean_normalize if mean_agg else sym_normalize
    built = []
    shapes: list[tuple[int, int]] = []
    for sg in subs:
        adj, feats, labels = sg.adj, sg.features, sg.labels
        tr, va, te = sg.train_mask, sg.val_mask, sg.test_mask
        nodes = (sg.nodes if sg.nodes is not None
                 else np.arange(sg.n, dtype=np.int64))
        if cfg.degree_sort:
            adj, feats, labels, tr, va, te, perm = degree_sorted_arrays(
                adj, feats, labels, tr, va, te)
            nodes = nodes[perm]
        a_csr = normalize(adj)
        loss_w = None
        if coeffs is not None:
            # Aggregator normalization (GraphSAINT §3.2): DIVIDE each edge
            # (v aggregates u) of the normalized propagation operand by
            # α_{u,v} = C_{u,v}/C_v — edges that co-occur with their
            # destination in every sample (α = 1, e.g. self-loops and all
            # edges of disjoint pools) are untouched; rarely co-sampled
            # edges are up-weighted by C_v/C_{u,v} so their expected
            # contribution over the pool matches the always-present case.
            # Applied to the subgraph-normalized operand (the repo
            # renormalizes per subgraph), so this debiases relative to the
            # pool rather than reproducing the paper's full-graph-Ã form.
            rows_l = np.repeat(np.arange(a_csr.n_rows, dtype=np.int64),
                               a_csr.row_nnz())
            alpha = coeffs.edge_alpha(nodes[rows_l],
                                      nodes[a_csr.col.astype(np.int64)],
                                      g.n)
            a_csr = dataclasses.replace(a_csr, val=a_csr.val / alpha)
            loss_w = coeffs.loss_weights(nodes)
        prop, _ = csr_to_bcoo_host(a_csr, cfg.block, cfg.block)
        prop_t, meta_t = csr_to_bcoo_host(a_csr.transpose(), cfg.block,
                                          cfg.block)
        fro = float(np.sqrt(np.sum(a_csr.val.astype(np.float64) ** 2)))
        built.append((prop, prop_t, meta_t, fro, feats, labels, tr, va, te,
                      nodes, loss_w, sg.n))
        shapes.append((prop.n_row_blocks, prop.s_total))

    buckets, assign = make_buckets(shapes, cfg.n_buckets)

    pool_subs: list[HostSubgraph] = []
    for i, (prop, prop_t, meta_t, fro, feats, labels, tr, va, te,
            nodes, loss_w, n_valid) in enumerate(built):
        b = buckets[int(assign[i])]
        prop = prop.pad_to(b.n_blocks, b.s_pad)
        prop_t = prop_t.pad_to(b.n_blocks, b.s_pad)
        meta_t = pad_block_meta(meta_t, b.n_blocks)
        n_pad = b.n_blocks * cfg.block
        feats_p, labels_p, tr_p, va_p, te_p = pad_node_arrays(
            n_pad, feats, labels, tr, va, te, g.multilabel)
        loss_w_p = (np.pad(loss_w, (0, n_pad - loss_w.shape[0]))
                    if loss_w is not None else None)
        pool_subs.append(HostSubgraph(
            sub_id=i, bucket_id=int(assign[i]),
            nodes=nodes, n_valid=n_valid,
            prop=prop, prop_t=prop_t, meta=meta_t, fro=fro,
            features=feats_p, labels=labels_p,
            train_mask=tr_p, val_mask=va_p, test_mask=te_p,
            loss_w=loss_w_p,
        ))

    return SubgraphPool(
        subgraphs=pool_subs, buckets=buckets,
        num_classes=g.num_classes, multilabel=g.multilabel,
        feat_dim=g.features.shape[1], mean_agg=mean_agg, block=cfg.block,
        n_nodes=g.n, node_labels=g.labels,
        node_val_mask=g.val_mask, node_test_mask=g.test_mask,
        saint=coeffs)
