"""GNN models as ``nn.Module``s with streaming-inference hooks: GCN,
GraphSAGE (MEAN) and GCNII, the paper's three."""
from repro_torch.models.gnn import gcn, gcnii, graphsage

MODELS = {"gcn": gcn, "graphsage": graphsage, "gcnii": gcnii}

__all__ = ["MODELS", "gcn", "graphsage", "gcnii"]
