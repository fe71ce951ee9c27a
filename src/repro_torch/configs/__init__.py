"""Architecture registry of the port (the KG archs kgat, kgcn, kgin and the
GNN arch gcn-cora)."""

from __future__ import annotations

from .base import ArchSpec, ShapeSpec
from .gcn_cora import GCN_CORA
from .kgnn_paper import KGAT, KGCN, KGIN

__all__ = ["ARCHS", "get", "ArchSpec", "ShapeSpec"]

ARCHS = {a.name: a for a in (GCN_CORA, KGAT, KGCN, KGIN)}


def get(name: str) -> ArchSpec:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(ARCHS)}") from None
