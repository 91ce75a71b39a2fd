"""GNN models as ``nn.Module``s with streaming-inference hooks.

GCN is ported; GraphSAGE and GCNII come with the training port.
"""
from repro_torch.models.gnn import gcn

MODELS = {"gcn": gcn}

__all__ = ["MODELS", "gcn"]
