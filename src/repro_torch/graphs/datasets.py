"""Dataset registry (paper Table 6 stats, synthetic stand-ins).

``scale`` shrinks node/edge counts while preserving the shape of the degree
distribution and the paper's relative dataset ordering. A copy of
``repro.graphs.datasets``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.graphs.synthetic import GraphData, sbm_graph


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    nodes: int
    edges: int
    classes: int
    feat_dim: int
    multilabel: bool
    label_rate: float
    metric: str          # accuracy | f1_micro | auc


# Paper Table 6.
DATASETS: dict[str, DatasetSpec] = {
    "reddit": DatasetSpec("reddit", 232_965, 11_606_919, 41, 602,
                          False, 0.6586, "accuracy"),
    "yelp": DatasetSpec("yelp", 716_847, 6_977_409, 100, 300,
                        True, 0.75, "f1_micro"),
    "ogbn-proteins": DatasetSpec("ogbn-proteins", 132_534, 39_561_252, 2, 8,
                                 True, 0.65, "auc"),
    "ogbn-products": DatasetSpec("ogbn-products", 2_449_029, 61_859_076, 47,
                                 100, False, 0.0803, "accuracy"),
}


def load_dataset(name: str, scale: float = 1.0, seed: int = 0) -> GraphData:
    spec = DATASETS[name]
    n = max(int(spec.nodes * scale), 256)
    avg_deg = spec.edges / spec.nodes
    return sbm_graph(
        n_nodes=n,
        n_clusters=spec.classes,
        avg_degree=avg_deg,
        feat_dim=spec.feat_dim,
        label_rate=spec.label_rate,
        multilabel=spec.multilabel,
        seed=seed,
        name=spec.name,
    )
