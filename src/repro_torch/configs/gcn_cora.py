"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden 16, mean/sym-norm (port of
``repro/configs/gcn_cora.py``)."""

from repro_torch.models.gnn import GCNConfig

from .base import GNN_SHAPES, ArchSpec

GCN_CORA = ArchSpec(
    name="gcn-cora",
    family="gnn",
    source="arXiv:1609.02907 (Kipf & Welling)",
    model_cfg=GCNConfig(n_layers=2, d_in=1433, d_hidden=16, n_classes=7),
    shapes=GNN_SHAPES,
)
