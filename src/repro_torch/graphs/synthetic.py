"""Synthetic cluster-structured graphs.

Real Reddit/Yelp/OGB data cannot ship offline, so the data pipeline
generates stochastic-block-model (SBM) graphs with power-law degree
propensities. This matches the paper's own rationale for why RSC works
(App. A.1): real graphs are cluster-structured ⇒ Ã is low-(stable-)rank ⇒
column-row sampling has low error.

A copy of ``repro.graphs.synthetic``: the same numpy calls in the same
order, so one seed gives a bit-identical graph in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.csr import CSR


@dataclasses.dataclass
class GraphData:
    adj: CSR                  # raw 0/1 adjacency (undirected, no self-loops)
    features: np.ndarray      # (N, d_in) float32
    labels: np.ndarray        # (N,) int64 or (N, C) float32 multilabel
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    multilabel: bool = False
    name: str = "synthetic"
    # For subgraphs: the parent-graph node id of each local node (None for
    # root graphs).
    nodes: np.ndarray | None = None

    @property
    def n(self) -> int:
        return self.adj.n_rows


def sbm_graph(
    n_nodes: int,
    n_clusters: int,
    avg_degree: float,
    feat_dim: int,
    *,
    p_in_out_ratio: float = 8.0,
    powerlaw: float = 1.6,
    label_rate: float = 0.65,
    multilabel: bool = False,
    noise: float = 1.0,
    seed: int = 0,
    name: str = "synthetic",
) -> GraphData:
    """Degree-corrected SBM with power-law propensities."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, n_clusters, size=n_nodes)

    # Power-law degree propensity, normalized to mean 1.
    theta = rng.pareto(powerlaw, size=n_nodes) + 1.0
    theta /= theta.mean()

    target_edges = int(n_nodes * avg_degree / 2)
    # Sample endpoints ∝ theta; accept within-cluster with prob ratio.
    p = theta / theta.sum()
    m_try = int(target_edges * 2.2)
    u = rng.choice(n_nodes, size=m_try, p=p)
    v = rng.choice(n_nodes, size=m_try, p=p)
    same = z[u] == z[v]
    keep_prob = np.where(same, 1.0, 1.0 / p_in_out_ratio)
    keep = (rng.random(m_try) < keep_prob) & (u != v)
    u, v = u[keep][:target_edges], v[keep][:target_edges]

    rows = np.concatenate([u, v])
    cols = np.concatenate([v, u])
    # dedupe
    key = rows.astype(np.int64) * n_nodes + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    adj = CSR.from_coo(rows.astype(np.int64), cols.astype(np.int64),
                       np.ones(rows.shape[0], np.float32),
                       (n_nodes, n_nodes))

    centroids = rng.standard_normal((n_clusters, feat_dim)).astype(np.float32)
    feats = centroids[z] + noise * rng.standard_normal(
        (n_nodes, feat_dim)).astype(np.float32)

    if multilabel:
        n_lab = n_clusters
        labels = np.zeros((n_nodes, n_lab), dtype=np.float32)
        labels[np.arange(n_nodes), z] = 1.0
        # correlated second label
        z2 = (z + rng.integers(0, 2, n_nodes)) % n_lab
        labels[np.arange(n_nodes), z2] = 1.0
    else:
        labels = z.astype(np.int64)

    order = rng.permutation(n_nodes)
    n_train = int(label_rate * n_nodes)
    n_val = int(0.1 * n_nodes)
    train_mask = np.zeros(n_nodes, bool)
    val_mask = np.zeros(n_nodes, bool)
    test_mask = np.zeros(n_nodes, bool)
    train_mask[order[:n_train]] = True
    val_mask[order[n_train:n_train + n_val]] = True
    test_mask[order[n_train + n_val:]] = True

    return GraphData(adj=adj, features=feats, labels=labels,
                     train_mask=train_mask, val_mask=val_mask,
                     test_mask=test_mask, num_classes=n_clusters,
                     multilabel=multilabel, name=name)
