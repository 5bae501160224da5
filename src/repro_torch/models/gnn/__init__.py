"""The GNN family of the port: ``repro/models/gnn`` on PyTorch."""
from repro_torch.models.gnn.graph import GraphBatch, synthetic_graph
from repro_torch.models.gnn import gatedgcn, graphcast, nequip, equiformer_v2, so3, sampler

__all__ = [
    "GraphBatch",
    "synthetic_graph",
    "gatedgcn",
    "graphcast",
    "nequip",
    "equiformer_v2",
    "so3",
    "sampler",
]
