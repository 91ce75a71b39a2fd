"""The benchmark's graph generator: a degree-corrected stochastic block
model with power-law propensities, standing in for the paper's datasets
(RSC, Table 6) with their node count, average degree, classes, feature
width and label rate.

A frozen copy of ``repro_torch.graphs.synthetic.sbm_graph`` (itself a copy
of ``repro.graphs.synthetic``) with one change: the original draws 2.2x
the target edge count once and keeps what the in/out-cluster acceptance
lets through (~15% of the draws for 41 classes), then drops duplicates, so
its graphs hold about a third of the degree they ask for. This copy keeps
drawing until ``n * avg_degree / 2`` distinct undirected pairs are kept, so
a row holds ``avg_degree`` entries on average. Plain numpy; it imports
nothing of the program.

A configuration's graph is drawn once, from its own ``graph_seed``; a
run's seed relabels its nodes (``graph_of``). Every seed then trains on
the same graph, in another node order, with its own weights and dropout.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """A raw undirected 0/1 adjacency in CSR form, with node data."""

    rowptr: np.ndarray        # (n + 1,) int64
    col: np.ndarray           # (nnz,) int32, sorted within each row
    features: np.ndarray      # (n, d_in) float32
    labels: np.ndarray        # (n,) int64
    train_mask: np.ndarray    # (n,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int

    @property
    def n(self) -> int:
        return int(self.rowptr.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def rows(self) -> np.ndarray:
        """The row index of every entry."""
        return np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.rowptr))


def csr_from_coo(rows: np.ndarray, cols: np.ndarray, n: int):
    """(rowptr, col) of the n x n pattern with entries (rows, cols), sorted
    by row and then by column (the original's ``CSR.from_coo``)."""
    key = np.sort(rows.astype(np.int64) * n + cols)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(key // n, minlength=n))
    return rowptr, (key % n).astype(np.int32)


def sbm_graph(n_nodes: int, n_clusters: int, avg_degree: float,
              feat_dim: int, *, p_in_out_ratio: float = 8.0,
              powerlaw: float = 1.6, label_rate: float = 0.65,
              noise: float = 1.0, seed: int = 0,
              relabel: int | None = None) -> Graph:
    """The graph of ``seed``: ``n_nodes`` nodes in ``n_clusters`` classes,
    ``n_nodes * avg_degree / 2`` distinct undirected edges, features
    ``centroid[class] + noise * N(0, 1)``, and a random split of
    ``label_rate`` train, 10% validation, the rest test. ``relabel`` (a
    seed): the nodes renamed in a random order drawn from it."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, n_clusters, size=n_nodes)
    theta = rng.pareto(powerlaw, size=n_nodes) + 1.0
    theta /= theta.mean()
    p = theta / theta.sum()

    target = int(round(n_nodes * avg_degree / 2))
    # Rounds of draws until ``target`` distinct undirected pairs are kept.
    # The first round draws 2.2x the target, as the original does; each
    # later one what the last round's yield of new pairs needs, +10%.
    keys, have, rate = [], 0, 1 / 2.2
    while have < target:
        m_try = max(int((target - have) / rate * 1.1), 1024)
        u = rng.choice(n_nodes, size=m_try, p=p)
        v = rng.choice(n_nodes, size=m_try, p=p)
        keep_prob = np.where(z[u] == z[v], 1.0, 1.0 / p_in_out_ratio)
        keep = (rng.random(m_try) < keep_prob) & (u != v)
        u, v = u[keep], v[keep]
        keys.append(np.minimum(u, v).astype(np.int64) * n_nodes
                    + np.maximum(u, v))
        _, first = np.unique(np.concatenate(keys), return_index=True)
        rate = max(first.size - have, 1) / m_try
        have = first.size
    # the first ``target`` distinct pairs, in the order they were drawn
    pairs = np.concatenate(keys)[np.sort(first)[:target]]
    u, v = pairs // n_nodes, pairs % n_nodes


    centroids = rng.standard_normal((n_clusters, feat_dim), dtype=np.float32)
    feats = centroids[z] + np.float32(noise) * rng.standard_normal(
        (n_nodes, feat_dim), dtype=np.float32)

    order = rng.permutation(n_nodes)
    n_train = int(label_rate * n_nodes)
    n_val = int(0.1 * n_nodes)
    masks = [np.zeros(n_nodes, bool) for _ in range(3)]
    masks[0][order[:n_train]] = True
    masks[1][order[n_train:n_train + n_val]] = True
    masks[2][order[n_train + n_val:]] = True

    if relabel is not None:                # node perm[i] becomes node i
        perm = np.random.default_rng(relabel).permutation(n_nodes)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n_nodes)
        u, v = inv[u], inv[v]
        feats, z = feats[perm], z[perm]
        masks = [m[perm] for m in masks]
    rowptr, col = csr_from_coo(np.concatenate([u, v]),
                               np.concatenate([v, u]), n_nodes)
    return Graph(rowptr=rowptr, col=col, features=feats,
                 labels=z.astype(np.int64), train_mask=masks[0],
                 val_mask=masks[1], test_mask=masks[2],
                 num_classes=n_clusters)


def graph_of(data: dict, seed: int) -> Graph:
    """The graph a configuration's ``data`` block describes (drawn from its
    ``graph_seed``), its nodes relabelled in an order drawn from ``seed``."""
    return sbm_graph(
        n_nodes=int(data["nodes"]), n_clusters=int(data["classes"]),
        avg_degree=float(data["avg_degree"]), feat_dim=int(data["feat_dim"]),
        p_in_out_ratio=float(data["p_in_out_ratio"]),
        powerlaw=float(data["powerlaw"]), label_rate=float(data["label_rate"]),
        noise=float(data["noise"]), seed=int(data["graph_seed"]),
        relabel=seed)
