"""Graph data: synthetic SBM generators and the dataset registry."""
from repro_torch.graphs.datasets import DATASETS, load_dataset
from repro_torch.graphs.synthetic import GraphData, sbm_graph

__all__ = ["DATASETS", "GraphData", "load_dataset", "sbm_graph"]
