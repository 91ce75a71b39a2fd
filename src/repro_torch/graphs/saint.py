"""GraphSAINT random-walk sampler (Zeng et al. 2020) — mini-batch setting.

A copy of ``repro.graphs.saint`` (host numpy): the same
``np.random.Generator`` draws give the same walks, subgraphs and
coefficients.

Per the paper's footnote 1 (§3.3.1), sub-graphs are sampled OFFLINE up
front; during training the RSC caching mechanism is applied per sampled
subgraph. ``random_walk_subgraph`` implements the RW sampler (roots × walk
length) used by the paper's GraphSAINT rows in Table 3.

``saint_coefficients`` computes the sampled-subgraph bias corrections of
the GraphSAINT paper (§3.2 there): with an offline pool the node/edge
appearance counts C_v / C_{u,v} are exact pool statistics, giving

* loss normalization   λ_v ∝ C_v      — train-node loss weight 1/λ_v,
* aggregator normalization α_{u,v} = C_{u,v} / C_v — every subgraph's
  propagation-operand edge (u→v) is DIVIDED by α, up-weighting edges that
  are rarely present when their destination is sampled.

For a disjoint partition (``ldg`` pools) every node and edge appears
exactly once, so λ is uniform and α ≡ 1: the corrections are identities
and disjoint training is unchanged. Overlapping random-walk pools get the
debiasing.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.synthetic import GraphData
from repro_torch.sparse.csr import CSR


@dataclasses.dataclass(frozen=True)
class SaintCoefficients:
    """Pool-level GraphSAINT normalization statistics (parent-id space)."""

    node_counts: np.ndarray      # (n,) int64 — C_v over the pool
    n_samples: int               # pool size N
    # Edge appearance counts, keyed by parent-space u * n + v.
    edge_keys: np.ndarray        # (m,) int64, sorted
    edge_counts: np.ndarray      # (m,) int64 — C_{u,v}

    def loss_weights(self, nodes: np.ndarray) -> np.ndarray:
        """1/λ_v for a subgraph's parent-node ids (λ_v = C_v / N).

        The loss normalizes by Σ weights (self-normalized estimator), so
        the N factor cancels; weights are returned as N / C_v for
        readability. Nodes sampled once per pool pass get weight N.
        """
        c = self.node_counts[nodes].astype(np.float64)
        return (self.n_samples / np.maximum(c, 1.0)).astype(np.float32)

    def edge_alpha(self, rows: np.ndarray, cols: np.ndarray,
                   n: int) -> np.ndarray:
        """α_{u,v} = C_{u,v} / C_v for parent-space edges u→v (row v in
        the propagation operand Ã_{v,u}: v aggregates, u is the source).

        Self-loops (added by the GCN normalization, absent from the raw
        adjacency the counts were taken over) co-occur with their node by
        construction — C_{v,v} = C_v — so the diagonal gets α = 1 exactly
        rather than the unknown-edge fallback.
        """
        c_v = np.maximum(self.node_counts[rows], 1)
        diag = rows == cols
        if len(self.edge_keys) == 0:
            return np.where(diag, 1.0, 1.0 / c_v).astype(np.float32)
        key = rows.astype(np.int64) * n + cols.astype(np.int64)
        idx = np.clip(np.searchsorted(self.edge_keys, key), 0,
                      len(self.edge_keys) - 1)
        c_uv = np.where(self.edge_keys[idx] == key, self.edge_counts[idx], 1)
        c_uv = np.where(diag, c_v, c_uv)
        return (c_uv / c_v).astype(np.float32)


def saint_coefficients(subgraphs: list[GraphData],
                       n_parent: int) -> SaintCoefficients:
    """Exact pool appearance counts C_v and C_{u,v} over an offline pool.

    Every subgraph must carry parent ids (``GraphData.nodes``); edges are
    counted in parent space as (row=v aggregating, col=u source) pairs of
    the subgraph adjacency.
    """
    node_counts = np.zeros(n_parent, dtype=np.int64)
    keys = []
    for sg in subgraphs:
        if sg.nodes is None:
            raise ValueError("subgraph lacks parent node ids "
                             "(GraphData.nodes)")
        node_counts[sg.nodes] += 1
        rows_l = np.repeat(np.arange(sg.n, dtype=np.int64),
                           sg.adj.row_nnz())
        cols_l = sg.adj.col.astype(np.int64)
        keys.append(sg.nodes[rows_l] * n_parent + sg.nodes[cols_l])
    if keys:
        allk = np.concatenate(keys)
        edge_keys, edge_counts = np.unique(allk, return_counts=True)
    else:
        edge_keys = np.zeros(0, dtype=np.int64)
        edge_counts = np.zeros(0, dtype=np.int64)
    return SaintCoefficients(
        node_counts=node_counts, n_samples=max(len(subgraphs), 1),
        edge_keys=edge_keys, edge_counts=edge_counts.astype(np.int64))


def random_walk_subgraph(
    g: GraphData,
    roots: int,
    walk_length: int,
    rng: np.random.Generator,
) -> GraphData:
    """Sample node-induced subgraph from `roots` random walks."""
    adj = g.adj
    start = rng.choice(g.n, size=roots, replace=True).astype(np.int64)
    visited = [start]
    frontier = start
    for _ in range(walk_length):
        if adj.nnz == 0:
            break
        lo = adj.rowptr[frontier]
        deg = adj.rowptr[frontier + 1] - lo
        # one uniform draw per walker; degree-0 walkers stay put
        off = (rng.random(frontier.shape[0]) * deg).astype(np.int64)
        idx = np.clip(lo + off, 0, adj.nnz - 1)
        nxt = np.where(deg > 0, adj.col[idx].astype(np.int64), frontier)
        visited.append(nxt)
        frontier = nxt
    nodes = np.unique(np.concatenate(visited))
    return induced_subgraph(g, nodes)


def induced_subgraph(g: GraphData, nodes: np.ndarray) -> GraphData:
    remap = -np.ones(g.n, dtype=np.int64)
    remap[nodes] = np.arange(nodes.shape[0])
    rows_all = np.repeat(np.arange(g.n, dtype=np.int64), g.adj.row_nnz())
    cols_all = g.adj.col.astype(np.int64)
    m = (remap[rows_all] >= 0) & (remap[cols_all] >= 0)
    sub = CSR.from_coo(remap[rows_all[m]], remap[cols_all[m]],
                       g.adj.val[m], (nodes.shape[0], nodes.shape[0]))
    parent = (g.nodes[nodes] if g.nodes is not None
              else np.asarray(nodes, dtype=np.int64))
    return GraphData(
        adj=sub,
        features=g.features[nodes],
        labels=g.labels[nodes],
        train_mask=g.train_mask[nodes],
        val_mask=g.val_mask[nodes],
        test_mask=g.test_mask[nodes],
        num_classes=g.num_classes,
        multilabel=g.multilabel,
        name=f"{g.name}-saint",
        nodes=parent,
    )
